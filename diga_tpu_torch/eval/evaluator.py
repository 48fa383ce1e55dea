"""Two-scale max-merge evaluation on one device.

Counterpart of ``diga_tpu/eval/evaluator.py`` (:27-39 and
``TwoScaleEvaluator``).  Protocol (reference: evaluate_val.py:73-93):
  1. forward the full-resolution image
  2. forward a bilinear (align_corners=True) downscale (e.g. 512x1024)
  3. upsample both logit maps to label resolution (align_corners=True)
  4. elementwise max-merge, argmax
  5. accumulate the confusion matrix on the device

Tensors at this surface are NHWC, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.metrics import RunningScore
from ..ops.resize import resize_bilinear


def two_scale_logits(apply_fn: Callable, image: torch.Tensor,
                     out_hw: tuple[int, int], ds_hw: tuple[int, int]) -> torch.Tensor:
    """max(upsample(f(x)), upsample(f(downscale(x)))) at out_hw (NHWC)."""
    up_full = resize_bilinear(apply_fn(image), out_hw)
    up_ds = resize_bilinear(apply_fn(resize_bilinear(image, ds_hw)), out_hw)
    return torch.maximum(up_full, up_ds)


class TwoScaleEvaluator:
    """Streaming two-scale evaluator.

    ``apply_fn(image) -> logits`` is the inference-mode model, NHWC image
    in, NHWK logits out at any stride.
    """

    def __init__(self, apply_fn: Callable, num_classes: int = 19,
                 out_hw: tuple[int, int] = (1024, 2048),
                 ds_hw: tuple[int, int] = (512, 1024),
                 device: torch.device | str = "cuda"):
        self.apply_fn = apply_fn
        self.num_classes = num_classes
        self.out_hw = tuple(out_hw)
        self.ds_hw = tuple(ds_hw)
        self.device = torch.device(device)
        self.score = RunningScore(num_classes, self.device)

    def update(self, image, label) -> torch.Tensor:
        """Score one NHWC image batch against its (B, H, W) labels; returns
        the (B, H, W) predictions on the device."""
        with torch.inference_mode():
            image = torch.as_tensor(image).to(self.device, non_blocking=True)
            label = torch.as_tensor(label).to(self.device, non_blocking=True)
            merged = two_scale_logits(self.apply_fn, image, self.out_hw, self.ds_hw)
            pred = torch.argmax(merged, dim=-1)
            self.score.update(label, pred)
        return pred
