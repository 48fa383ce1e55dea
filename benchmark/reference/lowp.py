"""The precisions the reference runs in.

``f32``: every convolution and matmul in float32 with TF32 off, the
yardstick.  ``fp8``: the control, the nearest precision below the
configurations' bfloat16: the forwards under bfloat16 autocast, with the
input and the weight of every convolution and linear layer rounded to
float8 e4m3 (one scale per tensor, its largest magnitude at 448) before
the product, as an fp8 GEMM with higher-precision accumulation computes
it.  The rounding passes gradients straight through, so a training step
runs its backward in the same precision.
"""

from __future__ import annotations

import contextlib
import types

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at a per-tensor scale, in x's dtype,
    with an identity gradient."""
    scale = x.detach().abs().amax().float().clamp(min=1e-12) / FP8_MAX
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float().mul(scale).to(x.dtype)
    return x + (q - x).detach()


def _conv_fp8(self, x):
    return self._conv_forward(fp8_round(x), fp8_round(self.weight), self.bias)


def _linear_fp8(self, x):
    return F.linear(fp8_round(x), fp8_round(self.weight), self.bias)


@contextlib.contextmanager
def _fp8_layers(modules):
    patched = []
    for root in modules:
        for m in root.modules():
            if isinstance(m, nn.Conv2d):
                m.forward = types.MethodType(_conv_fp8, m)
            elif isinstance(m, nn.Linear):
                m.forward = types.MethodType(_linear_fp8, m)
            else:
                continue
            patched.append(m)
    try:
        yield
    finally:
        for m in patched:
            del m.forward


@contextlib.contextmanager
def precision_scope(precision: str, modules):
    """Yields ``amp()``, the context the forwards run under."""
    if precision not in ("f32", "fp8"):
        raise ValueError(f"precision {precision!r}: expected 'f32' or 'fp8'")
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark)
    # cuDNN's heuristics, not its timed search over algorithms, which costs
    # tens of seconds of new f32 shapes in every run
    b.cudnn.benchmark = False
    try:
        if precision == "f32":
            b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
            yield contextlib.nullcontext
        else:
            device = next(modules[0].parameters()).device
            with _fp8_layers(modules):
                yield lambda: torch.autocast(device.type, dtype=torch.bfloat16)
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.benchmark = saved
