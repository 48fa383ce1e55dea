"""Assemble the model and its eval forward from a preset config.

Counterpart of the eval part of ``diga_tpu/train/build.py``:
``make_model`` (:31-58) and the ``eval_apply`` of ``build_experiment``
(:250-277), with the previous stage's weights read from a role-keyed
``student.pth`` (reference stage chaining).  Training comes in a later
slice of the port.
"""

from __future__ import annotations

import os
from typing import Callable

import torch

from ..configs.presets import ExperimentConfig
from ..models.resnet_deeplab import DeepLabV2
from ..utils.checkpoint import load_role_keyed


def make_model(cfg: ExperimentConfig) -> DeepLabV2:
    """DeepLabV2 at the preset's class count (``extra['layers']`` for tiny depths)."""
    if cfg.extra.get("model", "deeplab") != "deeplab":
        raise NotImplementedError(
            f"model {cfg.extra['model']!r} is not ported yet (DeepLabV2 only)")
    layers = tuple(cfg.extra.get("layers", (3, 4, 23, 3)))
    return DeepLabV2(num_classes=cfg.train.num_classes, layers=layers)


def build_eval(cfg: ExperimentConfig, weight_dir: str | None,
               device: torch.device) -> tuple[Callable, DeepLabV2]:
    """(eval_apply, model): ``eval_apply(image_nhwc) -> logits_nhwc``.

    Weights come from ``<weight_dir>/student.pth``; with no ``weight_dir``
    the model keeps a random init drawn from ``cfg.train.seed``, as the
    JAX package's ``build_experiment`` does.
    """
    gen_state = torch.random.get_rng_state()
    torch.manual_seed(cfg.train.seed)
    try:
        model = make_model(cfg)
    finally:
        torch.random.set_rng_state(gen_state)
    if weight_dir is not None:
        if not os.path.exists(os.path.join(weight_dir, "student.pth")):
            raise FileNotFoundError(f"no student.pth in --weight_dir {weight_dir!r}")
        model.load_state_dict(load_role_keyed(weight_dir, ["student"])["student"], strict=True)
    dtype = torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else torch.float32
    model.eval().set_compute_dtype(dtype).to(device)
    if device.type == "cuda":
        # the eval runs a few fixed shapes many times: let cuDNN time its
        # algorithms once per shape.  Its heuristic choice for the dilated
        # ASPP convs is a direct kernel that made the two-scale eval take
        # seconds per image (chip_smoke.py --profile on an H100).
        torch.backends.cudnn.benchmark = True
    rgb_input = cfg.extra.get("rgb_input", False)

    def eval_apply(img: torch.Tensor) -> torch.Tensor:
        if rgb_input:
            # semiseg feeds RGB (BGR->RGB flip at model input,
            # semi-supervised_segmentation/evaluate_val.py:76)
            img = torch.flip(img, dims=(-1,))
        _, _, logits, _ = model(img.permute(0, 3, 1, 2))
        return logits.permute(0, 2, 3, 1)

    return eval_apply, model
