"""Bilinear resize with torch ``align_corners=True`` semantics.

Counterpart of ``diga_tpu/ops/resize.py::resize_bilinear`` (:48-87).  The
JAX package writes the resize as two interpolation-matrix products, a
rewrite for the TPU's matrix unit; here it is the plain op that rewrite
stands for, ``F.interpolate``.  As there, the interpolation runs in f32
whatever the input dtype, and the result is cast back: bf16 weights would
shift eval logits visibly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of an NHWC (or HWC) tensor; a no-op at equal size."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    h, w = x.shape[1], x.shape[2]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x[0] if squeeze else x
    # NHWC -> NCHW is a channels_last view; interpolate keeps that format
    y = F.interpolate(x.permute(0, 3, 1, 2).to(torch.float32), size=(oh, ow),
                      mode="bilinear", align_corners=align_corners)
    out = y.to(x.dtype).permute(0, 2, 3, 1)
    return out[0] if squeeze else out
