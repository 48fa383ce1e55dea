"""The sharded-op cases of tests/test_torch_port_spatial.py, and a rank body.

Imported by the test file and by the ranks ``dist.launch`` spawns (which
unpickle ``group_ops`` by name); it imports torch, never jax.  Each case
makes its whole input from a numpy seed, runs the one-device op on it, runs
the sharded op on this shard's rows, and returns the largest difference
from this shard's rows of the one-device output (a shape mismatch raises).
The heights are uneven, leave a shard of 3, 4 or 8 with no rows, and meet
halos deeper than a shard (the dilation-24 conv).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from diga_tpu_torch.models.resnet_deeplab import FusedGroupNorm, SEBlock
from diga_tpu_torch.ops.resize import resize_bilinear
from diga_tpu_torch.parallel import spatial, spatial_ops

# (kernel, stride, dilation, padding): R101's 7x7/2 stem and 1x1/2 stride
# convs, the ASPP's dilation 24 and 6, layer3's dilation 2, HRNet's 3x3/2
CONVS = [(7, 2, 1, 3), (1, 2, 1, 0), (3, 1, 24, 24), (3, 1, 6, 6), (3, 1, 2, 2),
         (3, 2, 1, 1), (3, 1, 1, 1), (1, 1, 1, 0)]
CONV_HEIGHTS = (5, 13, 32)
POOL_HEIGHTS = (5, 9, 16, 17, 32)
RESIZES = [((5, 7), (32, 13)), ((32, 64), (16, 32)), ((9, 13), (5, 7)), ((16, 9), (16, 20)),
           ((17, 5), (33, 5)), ((1, 4), (8, 6))]
NORM_HEIGHTS = (5, 13)


def _rows(t: torch.Tensor, shard: spatial.Shard, dim: int = 2) -> torch.Tensor:
    lo, hi = shard.rows(t.shape[dim])
    return t.narrow(dim, lo, hi - lo)


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape:
        raise AssertionError(f"sharded shape {tuple(got.shape)}, expected {tuple(want.shape)}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def _input(seed: int, shape) -> torch.Tensor:
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))
    return x.contiguous(memory_format=torch.channels_last) if x.dim() == 4 else x


def _module(m: nn.Module, seed: int) -> nn.Module:
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    return m.eval()


def conv_case(shard: spatial.Shard) -> float:
    worst = 0.0
    for i, (k, s, d, p) in enumerate(CONVS):
        conv = spatial_ops.convert_spatial(_module(nn.Conv2d(4, 8, k, s, p, d), i))
        for h in CONV_HEIGHTS:
            x = _input(100 * i + h, (2, 4, h, 6))
            want = conv(x)
            with shard.active():
                got = conv(_rows(x, shard))
            worst = max(worst, _err(got, _rows(want, shard)))
    return worst


def pool_case(shard: spatial.Shard) -> float:
    worst = 0.0
    for ceil_mode in (True, False):
        pool = spatial_ops.convert_spatial(nn.MaxPool2d(3, 2, 1, ceil_mode=ceil_mode))
        for h in POOL_HEIGHTS:
            x = _input(h, (1, 4, h, 7))
            want = pool(x)
            with shard.active():
                got = pool(_rows(x, shard))
            worst = max(worst, _err(got, _rows(want, shard)))
    return worst


def resize_case(shard: spatial.Shard) -> float:
    worst = 0.0
    for i, ((h, w), out_hw) in enumerate(RESIZES):
        x = _input(i, (1, h, w, 3))  # NHWC, as the eval resizes
        want = resize_bilinear(x, out_hw)
        got = spatial_ops.resize_rows(shard, _rows(x, shard, 1).permute(0, 3, 1, 2),
                                      out_hw).permute(0, 2, 3, 1)
        worst = max(worst, _err(got, _rows(want, shard, 1)))
    return worst


def group_norm_case(shard: spatial.Shard) -> float:
    worst = 0.0
    gn = _module(FusedGroupNorm(64), 1)
    for h in NORM_HEIGHTS:
        x = _input(h, (2, 64, h, 5)) * 3 + 1
        want = gn(x)  # outside a shard: group_norm_plain on the CPU
        with shard.active():
            got = gn(_rows(x, shard))
        worst = max(worst, _err(got, _rows(want, shard)))
    return worst


def se_case(shard: spatial.Shard) -> float:
    worst = 0.0
    se = _module(SEBlock(64), 2)
    for h in NORM_HEIGHTS:
        x = _input(h + 1, (2, 64, h, 5))
        want = se(x)
        with shard.active():
            got = se(_rows(x, shard))
        worst = max(worst, _err(got, _rows(want, shard)))
    return worst


def regions_case(shard: spatial.Shard) -> float:
    worst = 0.0
    for h in NORM_HEIGHTS:
        aux, pix = _input(h, (2, 5, h, 6)) * 4, _input(h + 7, (2, 8, h, 6))
        probs = torch.softmax(aux.reshape(2, 5, -1), dim=-1)
        want = torch.bmm(probs, pix.reshape(2, 8, -1).transpose(1, 2))
        got = spatial_ops.soft_regions(shard, _rows(aux, shard), _rows(pix, shard))
        worst = max(worst, _err(got, want))
    return worst


CASES = {"conv": conv_case, "max_pool": pool_case, "resize": resize_case,
         "group_norm": group_norm_case, "se_mean": se_case, "ocr_regions": regions_case}


def run_case(name: str, shard: spatial.Shard) -> float:
    with torch.no_grad():  # the eval's forward-only ops
        return CASES[name](shard)


def run_cases(shard: spatial.Shard) -> dict[str, float]:
    return {name: run_case(name, shard) for name in CASES}


def group_ops() -> dict[str, float]:
    """Every case on this rank's shard of the process group (the group
    transport: point-to-point halos, gloo heights)."""
    return run_cases(spatial.group_shard())

