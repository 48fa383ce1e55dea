"""The train state of the warm-up, DG and self-training stages.

Counterpart of ``diga_tpu/train/state.py`` (:23-63).  The JAX state is one
immutable pytree; here the step mutates the modules and the optimizer in
place, and the state holds them together with everything else a step
reads: the step counter, the frozen translator, the self-training class
centroids, and one explicit ``torch.Generator`` per kind of random draw
(source and target photometric factors, CrDoMix and DACS class
selections, student dropout, teacher dropout).
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn as nn

from ..models.resnet_deeplab import DeepLabV2
from ..ops.prototypes import Centroids


@dataclasses.dataclass
class SegTrainState:
    student: DeepLabV2
    teacher: DeepLabV2
    optimizer: torch.optim.Optimizer
    step: int
    gen_photometric: torch.Generator
    gen_mix: torch.Generator
    gen_student_dropout: torch.Generator
    gen_teacher_dropout: torch.Generator
    gen_photometric_target: torch.Generator
    gen_dacs: torch.Generator
    translator: nn.ModuleDict | None = None  # frozen {"enc_s", "dec_s2t"}
    centroids: Centroids | None = None  # self-training only, on the device


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def create_seg_state(student: DeepLabV2, optimizer: torch.optim.Optimizer, seed: int,
                     translator: nn.ModuleDict | None = None,
                     centroids: Centroids | None = None) -> SegTrainState:
    """Teacher = a copy of the student (reference create_teacher_params,
    util/utils.py:93-101), with no gradients; both in train mode (the
    reference never puts the teacher in eval mode)."""
    device = next(student.parameters()).device
    teacher = copy.deepcopy(student)
    teacher.requires_grad_(False)
    student.train()
    teacher.train()
    if translator is not None:
        translator.requires_grad_(False).eval()
    state = SegTrainState(
        student=student, teacher=teacher, optimizer=optimizer, step=0,
        gen_photometric=_generator(device, seed + 1),
        gen_mix=_generator(device, seed + 2),
        gen_student_dropout=_generator(device, seed + 3),
        gen_teacher_dropout=_generator(device, seed + 4),
        gen_photometric_target=_generator(device, seed + 5),
        gen_dacs=_generator(device, seed + 6),
        translator=translator,
        centroids=None if centroids is None else Centroids(
            centroids.vectors.to(device, torch.float32), centroids.counts.to(device, torch.float32)))
    student.final.head[0].generator = state.gen_student_dropout
    teacher.final.head[0].generator = state.gen_teacher_dropout
    return state
