"""Bilinear resize with torch ``align_corners=True`` semantics, and the
nearest resize of label maps.

Counterpart of ``diga_tpu/ops/resize.py::resize_bilinear`` (:48-87),
``resize_nearest`` (:90-111), ``resize_nearest_nhwc`` and
``upsample2x_nearest`` (:114-131).  The
JAX package writes the resize as two interpolation-matrix products, a
rewrite for the TPU's matrix unit; here it is the plain op that rewrite
stands for, ``F.interpolate``.  As there, the interpolation runs in f32
whatever the input dtype, and the result is cast back: bf16 weights would
shift eval logits visibly.
"""

from __future__ import annotations

import functools

import numpy as np
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


@functools.lru_cache(maxsize=256)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """The JAX package's nearest index rule floor(o · in/out), in float64 and
    clipped.  ``F.interpolate(mode="nearest")`` computes its scale in
    float32 and picks another row at some sizes, so the index is built here."""
    o = np.arange(out_size, dtype=np.float64)
    idx = np.floor(o * (in_size / out_size)).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest resize over the last two dims (..., H, W), e.g. (B, H, W) labels."""
    oh, ow = out_hw
    h, w = x.shape[-2], x.shape[-1]
    if (h, w) == (oh, ow):
        return x
    ih = torch.from_numpy(_nearest_index(h, oh)).to(x.device)
    iw = torch.from_numpy(_nearest_index(w, ow)).to(x.device)
    return x.index_select(-2, ih).index_select(-1, iw)


def resize_nearest_nhwc(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of an NHWC (or HWC) tensor over its H, W dims, with the
    float64 index rule of ``resize_nearest``."""
    oh, ow = out_hw
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (oh, ow):
        return x
    ih = torch.from_numpy(_nearest_index(h, oh)).to(x.device)
    iw = torch.from_numpy(_nearest_index(w, ow)).to(x.device)
    return x.index_select(-3, ih).index_select(-2, iw)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample of NHWC (``nn.Upsample(scale_factor=2)`` on NCHW)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
