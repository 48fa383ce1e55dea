"""The train state of the warm-up, DG and self-training stages.

Counterpart of ``diga_tpu/train/state.py`` (:23-63).  The JAX state is one
immutable pytree; here the step mutates the modules and the optimizer in
place, and the state holds them together with everything else a step
reads: the step counter, the frozen translator, the self-training class
centroids, and one explicit ``torch.Generator`` per kind of random draw
(source and target photometric factors, CrDoMix and DACS class
selections, student dropout, teacher dropout).

``state_dict``/``load_state_dict`` carry all of it for the full-state
checkpoints (``utils/checkpoint.py``): the student and teacher (BN
buffers included) and the frozen translator as reference role
state_dicts, and the step, the optimizer's state (SGD's momentum, or
AdamW's two moments and step counts), the centroids and each generator's
state.  A restored state continues bit for bit.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.nn as nn

from ..models.hrnet_ocr import HRNetOCR
from ..models.mit_daformer import MiTDAFormer
from ..models.resnet_deeplab import DeepLabV2
from ..ops.prototypes import Centroids

# every model has ``forward(x) -> (shallow, deep_or_aux, logits, feat)``,
# ``bn_stats_forward``, ``channel_dropout`` (the holder of its draws'
# generator), ``compute_dtype`` and ``set_compute_dtype``
SegModel = DeepLabV2 | HRNetOCR | MiTDAFormer


@dataclasses.dataclass
class SegTrainState:
    student: SegModel
    teacher: SegModel
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

    def generators(self) -> dict[str, torch.Generator]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name.startswith("gen_")}

    def state_dict(self) -> dict:
        """{"roles": {role: state_dict}, "state": {step, optimizer, centroids,
        generators}}, tensors where they live."""
        roles = {"student": reference_state_dict(self.student),
                 "teacher": reference_state_dict(self.teacher)}
        if self.translator is not None:
            roles.update({r: m.state_dict() for r, m in self.translator.items()})
        cents = None if self.centroids is None else {"vectors": self.centroids.vectors,
                                                     "counts": self.centroids.counts}
        return {"roles": roles,
                "state": {"step": self.step, "optimizer": self.optimizer.state_dict(),
                          "centroids": cents,
                          "generators": {k: g.get_state() for k, g in self.generators().items()}}}

    def load_state_dict(self, sd: dict) -> None:
        roles, st = sd["roles"], sd["state"]
        self.student.load_state_dict(roles["student"], strict=True)
        self.teacher.load_state_dict(roles["teacher"], strict=True)
        if self.translator is not None:
            for r, m in self.translator.items():
                m.load_state_dict(roles[r], strict=True)
        self.optimizer.load_state_dict(st["optimizer"])
        self.step = int(st["step"])
        if (st["centroids"] is None) != (self.centroids is None):
            raise ValueError("the checkpoint and the state disagree on having centroids")
        if self.centroids is not None:
            device = self.centroids.vectors.device
            self.centroids = Centroids(st["centroids"]["vectors"].to(device),
                                       st["centroids"]["counts"].to(device))
        for k, g in self.generators().items():
            g.set_state(st["generators"][k])
        attach_dropout_generators(self)


def reference_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """The model's state_dict in the reference layout (no BN batch counters)."""
    return {k: v for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}


def attach_dropout_generators(state: "SegTrainState") -> None:
    """Each model's random draws (the head dropout's; MiT's stochastic depth
    too) come from the state's own generators."""
    state.student.channel_dropout.generator = state.gen_student_dropout
    state.teacher.channel_dropout.generator = state.gen_teacher_dropout


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def create_seg_state(student: SegModel, optimizer: torch.optim.Optimizer, seed: int,
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
    attach_dropout_generators(state)
    return state
