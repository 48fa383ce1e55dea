"""The height-sharded forms of the ops the eval models run.

Each computes the rows its shard owns of its output, on the row layout of
``parallel/spatial.py``, from the input rows it fetches; with no shard
active the models never call them and every module is the one-device op.

  * ``conv2d``: any kernel, stride, dilation and padding.  The owned
    output rows [lo, hi) read input rows [lo·s − p, (hi−1)·s − p + (k−1)·d]
    along H, zeros outside [0, h); the conv then runs with padding (0, p_w).
    A 1x1 stride-1 conv is row-local and exchanges nothing (it also serves
    OCR's (B, C, K, 1) region tensors, which are not sharded).
  * ``max_pool2d``: the same window rule with −inf rows, and the output
    height by torch's rule for the whole height (ceil mode: 257 rows from
    512, not 256).
  * ``resize_rows``: the ``align_corners=True`` bilinear resize.  Each
    owned row's source rows and weights come from the whole heights in f32,
    as ATen computes them (``F.interpolate`` on a slab would take them from
    the slab's size); W is resized first on the fetched source rows, then H.
    Interpolated in f32 and cast back to x's dtype.
  * ``group_norm``: B2a (``group_norm_stats``) on the shard's rows, Σx and
    Σx² summed over the shards, ``fold_group_stats`` over the whole count
    H·W·C/G, then B2b (``group_norm_apply``).
  * ``spatial_mean``: the SE block's mean, f32 sums over the shards over
    the whole count.
  * ``soft_regions``: OCR's softmax over the pixel axis: the max over the
    shards, then Σexp and Σexp·pix in f32 over the shards.

``convert_spatial`` swaps every Conv2d and MaxPool2d of a model for its
sharded form in place (its class, as ``sync_bn.convert_sync_bn`` swaps
BN), so state_dicts keep their keys; the GroupNorm, the SE block, HRNet's
upsample and OCR's regions consult the shard themselves.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.group_norm import fold_group_stats, group_norm_apply, group_norm_stats
from .spatial import Shard, current, fill_rows, layout_of


def conv_out(h: int, k: int, s: int, p: int, d: int) -> int:
    return (h + 2 * p - d * (k - 1) - 1) // s + 1


def pool_out(h: int, k: int, s: int, p: int, d: int, ceil_mode: bool) -> int:
    """torch's pooling output size (``pooling_output_shape``)."""
    out = (h + 2 * p - d * (k - 1) - 1 + (s - 1 if ceil_mode else 0)) // s + 1
    if ceil_mode and (out - 1) * s >= h + p:
        out -= 1
    return out


def _windows(shard: Shard, h_out: int, s: int, p: int, extent: int):
    """need(q): the input rows of shard q's output rows of a window op."""

    def need(q: int) -> tuple[int, int]:
        lo, hi = shard.rows(h_out, q)
        return (lo * s - p, (hi - 1) * s - p + extent) if hi > lo else (0, 0)

    return need


def _window_op(shard: Shard, x: torch.Tensor, h_out: int, s: int, p: int, extent: int,
               fill: float, run) -> torch.Tensor:
    h = shard.height(x)
    slab = shard.fetch(x, h, _windows(shard, h_out(h), s, p, extent), fill)
    lo, hi = shard.rows(h_out(h))
    if hi == lo:  # no rows here: the op on one window, its rows dropped
        return run(fill_rows(x, 2, extent, fill))[:, :, :0]
    return run(slab)


def conv2d(shard: Shard, conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    (kh, _), (sh, _), (dh, _), (ph, pw) = (conv.kernel_size, conv.stride, conv.dilation,
                                           conv.padding)

    def run(t: torch.Tensor) -> torch.Tensor:
        return F.conv2d(t, conv.weight, conv.bias, conv.stride, (0, pw), conv.dilation,
                        conv.groups)

    if (kh, sh, ph) == (1, 1, 0):  # row-local
        return run(x) if x.shape[2] else run(fill_rows(x, 2, 1, 0.0))[:, :, :0]
    return _window_op(shard, x, lambda h: conv_out(h, kh, sh, ph, dh), sh, ph,
                      (kh - 1) * dh + 1, 0.0, run)


def max_pool2d(shard: Shard, pool: nn.MaxPool2d, x: torch.Tensor) -> torch.Tensor:
    k, s, p, d = (nn.modules.utils._pair(v) for v in
                  (pool.kernel_size, pool.stride or pool.kernel_size, pool.padding,
                   pool.dilation))

    def run(t: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(t, k, s, (0, p[1]), d, ceil_mode=pool.ceil_mode)

    return _window_op(shard, x, lambda h: pool_out(h, k[0], s[0], p[0], d[0], pool.ceil_mode),
                      s[0], p[0], (k[0] - 1) * d[0] + 1, float("-inf"), run)


@functools.lru_cache(maxsize=64)
def source_rows(h: int, oh: int) -> tuple[np.ndarray, ...]:
    """(y0, y1, λ0, λ1) of each of ``oh`` output rows from ``h`` input rows,
    ``align_corners=True``, in f32 as ATen computes them: the scale
    (h−1)/(oh−1), the source s·o, y0 = ⌊s·o⌋, y1 = y0 + 1 below the last
    row, λ1 = s·o − y0, λ0 = 1 − λ1."""
    scale = np.float32(h - 1) / np.float32(oh - 1) if oh > 1 else np.float32(0.0)
    src = scale * np.arange(oh, dtype=np.float32)
    y0 = src.astype(np.int64)
    y1 = y0 + (y0 < h - 1)
    l1 = src - y0.astype(np.float32)
    return y0, y1, np.float32(1.0) - l1, l1


def resize_rows(shard: Shard, x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear ``align_corners=True`` resize of sharded NCHW ``x`` to
    ``out_hw`` (global sizes), f32 inside, x's dtype out."""
    oh, ow = out_hw
    h = shard.height(x)
    if (h, x.shape[3]) == (oh, ow):
        return x
    y0, y1, l0, l1 = source_rows(h, oh)

    def need(q: int) -> tuple[int, int]:
        lo, hi = shard.rows(oh, q)
        return (int(y0[lo]), int(y1[hi - 1]) + 1) if hi > lo else (0, 0)

    slab = shard.fetch(x, h, need)
    lo, hi = shard.rows(oh)
    if hi == lo:
        return x.new_empty((x.shape[0], x.shape[1], 0, ow))
    xf = slab.to(torch.float32)
    if xf.shape[3] != ow:  # W first, on the source rows (row-local)
        xf = F.interpolate(xf, size=(xf.shape[2], ow), mode="bilinear", align_corners=True)
    a = need(shard.r)[0]

    def rows_of(v: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(v[lo:hi] - a).to(x.device)

    def weight(v: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(v[lo:hi]).to(x.device).view(1, 1, -1, 1)

    out = xf.index_select(2, rows_of(y0)) * weight(l0) + xf.index_select(2, rows_of(y1)) * weight(l1)
    return out.to(x.dtype).contiguous(memory_format=layout_of(x))


def group_norm(shard: Shard, x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int, eps: float) -> torch.Tensor:
    """GroupNorm of sharded NHWC ``x`` over the whole height."""
    x = x.contiguous()  # the kernels' layout (a conv's channels_last output already is)
    b, h, w, c = x.shape
    h_all = shard.height(x, dim=1)
    if h:
        s_c, s2_c, _, _ = group_norm_stats(x, scale, bias, num_groups, eps)  # B2a
        local = torch.stack([s_c, s2_c])
    else:
        local = torch.zeros((2, b, c), dtype=torch.float32, device=x.device)
    total = shard.all_reduce(local)
    mul, add = fold_group_stats(total[0], total[1], float(h_all * w * (c // num_groups)),
                                scale, bias, num_groups, eps, x.dtype)
    return group_norm_apply(x, mul, add) if h else x  # B2b


def spatial_mean(shard: Shard, x: torch.Tensor) -> torch.Tensor:
    """The (B, C) f32 mean of sharded NCHW ``x`` over H and W."""
    h_all = shard.height(x)
    total = shard.all_reduce(torch.sum(x, dim=(2, 3), dtype=torch.float32))
    return total / float(h_all * x.shape[3])


def soft_regions(shard: Shard, aux: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """(B, K, C) f32 region representations: softmax(aux) over every
    shard's pixels, weighting ``pix``'s, summed over the shards."""
    b, k = aux.shape[:2]
    c = pix.shape[1]
    a = aux.to(torch.float32).reshape(b, k, -1)
    local_max = (a.amax(-1) if a.shape[-1] else
                 torch.full((b, k), float("-inf"), device=a.device))
    e = torch.exp(a - shard.all_reduce(local_max, "max")[..., None])
    sums = torch.cat([torch.bmm(e, pix.to(torch.float32).reshape(b, c, -1).transpose(1, 2)),
                      e.sum(-1, keepdim=True)], dim=-1)
    total = shard.all_reduce(sums)
    return total[..., :c] / total[..., c:]


class SpatialConv2d(nn.Conv2d):
    """A Conv2d that is the sharded conv while a shard is active."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shard = current()
        return super().forward(x) if shard is None else conv2d(shard, self, x)


class SpatialMaxPool2d(nn.MaxPool2d):
    """A MaxPool2d that is the sharded pool while a shard is active."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shard = current()
        return super().forward(x) if shard is None else max_pool2d(shard, self, x)


def convert_spatial(model: nn.Module) -> nn.Module:
    """Make every Conv2d and MaxPool2d of ``model`` its sharded form in
    place (the same objects, their classes swapped: parameters, buffers and
    state_dict keys unchanged; a conv subclass keeps what it stores, such as
    ``BufferBiasConv2d``'s bias buffer, and must not have a forward of its
    own).  Outside a shard they compute what they did."""
    for m in model.modules():
        if isinstance(m, (SpatialConv2d, SpatialMaxPool2d)):
            continue
        if isinstance(m, nn.Conv2d):
            if (type(m).forward is not nn.Conv2d.forward or isinstance(m.padding, str)
                    or m.padding_mode != "zeros"):
                raise ValueError(f"convert_spatial: {type(m).__name__} with padding "
                                 f"{m.padding!r} ({m.padding_mode}) has no sharded form")
            m.__class__ = SpatialConv2d
        elif isinstance(m, nn.MaxPool2d):
            if type(m).forward is not nn.MaxPool2d.forward or m.return_indices:
                raise ValueError(f"convert_spatial: {type(m).__name__} (return_indices="
                                 f"{m.return_indices}) has no sharded form")
            m.__class__ = SpatialMaxPool2d
    return model
