"""The two-scale evaluation in plain PyTorch (DiGA ``evaluate_val.py:73-93``).

The model in eval mode on the full image and on its bilinear
(align_corners) downscale, both logit maps upsampled to the label's size,
the elementwise max, the argmax, and the confusion counts of the valid
pixels (rows the true class, columns the predicted one).
"""

from __future__ import annotations

import torch

from . import ops
from .lowp import precision_scope


@torch.no_grad()
def two_scale_logits(model: torch.nn.Module, image: torch.Tensor, out_hw, ds_hw,
                     precision: str = "f32", rgb_input: bool = False) -> torch.Tensor:
    """Merged NHWC f32 logits of an NHWC image batch."""
    model.eval()
    x = image.float().flip(-1) if rgb_input else image.float()
    with precision_scope(precision, [model]) as amp:
        ups = []
        for img in (x, ops.resize(x, ds_hw)):
            with amp():
                logits = model(img.permute(0, 3, 1, 2).contiguous())[2]
            ups.append(ops.resize(logits.float().permute(0, 2, 3, 1), out_hw))
    return torch.maximum(*ups)


def confusion(labels: torch.Tensor, preds: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(K, K) int64 counts over the pixels whose label is a class."""
    lt, lp = labels.reshape(-1).long(), preds.reshape(-1).long()
    valid = (lt >= 0) & (lt < num_classes)
    idx = lt[valid] * num_classes + lp[valid]
    return torch.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes)


def logit_gap(merged: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """Per pixel, how far the reference's logit of the predicted class lies
    below its best, over the largest |logit| of the image: (B, H, W)."""
    best = merged.amax(-1)
    chosen = torch.gather(merged, -1, preds.long()[..., None])[..., 0]
    scale = merged.abs().amax(dim=(1, 2, 3)).clamp(min=1e-12)
    return (best - chosen) / scale[:, None, None]
