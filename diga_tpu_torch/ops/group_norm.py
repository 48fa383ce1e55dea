"""GroupNorm forward over NHWC activations: hand-written CUDA kernel + plain version.

Counterpart of ``diga_tpu/ops/pallas_gn.py``, the Pallas pair
``_stats_kernel`` (B2a) and ``_norm_kernel`` (B2b).  In the port it is the
GroupNorm of the ASPP head wherever no gradient is needed: the eval
forward (six sites per scale) and the warm-up step's EMA teacher (six
sites per step).

``group_norm(x, scale, bias)`` takes the JAX layout: ``x`` is a contiguous
NHWC tensor, i.e. a channels_last NCHW activation permuted to NHWC (a view,
no copy).  On a CUDA tensor it launches the kernels of
``diga_tpu_torch/csrc/group_norm.cu`` or raises; on a CPU tensor it runs
the plain version, which repeats the kernel's arithmetic with PyTorch ops:
the FusedGroupNorm formula (E[x²] − mean², mul/add cast to x's dtype), not
``F.group_norm``'s two-pass variance.  Forward only, as in JAX: it raises
where autograd would need a backward.

Each wrapper adds one to ``launches[<name>]`` when it launches its
kernel; ``group_norm_stats`` issues two launches (partials, then the
ordered reduction and group fold) per call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import native
from .stats import sums_and_squares

launches = {"group_norm_stats": 0, "group_norm_apply": 0}

_MAX_VECTORS_PER_ROW = 1024  # C / (16 bytes / element size): one thread each
_MAX_GROUP_CHANNELS = 256  # C / groups: one fold-kernel thread each
_APPLY_THREADS = 256


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = native.load("group_norm")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.gn_stats.argtypes = [i, p, i, i, i, i, i, i, f, f, p, p, p, p, p, p, p, p]
    lib.gn_stats.restype = i
    lib.gn_apply.argtypes = [i, p, p, p, p, ll, i, ll, i, p]
    lib.gn_apply.restype = i
    return lib


def _check_x(x: torch.Tensor, num_groups: int) -> None:
    if x.dim() != 4:
        raise ValueError(f"group_norm: expected NHWC x of rank 4, got shape {tuple(x.shape)}")
    if x.dtype not in native.DTYPE_CODES:
        raise TypeError(f"group_norm: dtype must be float32 or bfloat16, got {x.dtype}")
    b, h, w, c = x.shape
    if b * h * w == 0:
        raise ValueError(f"group_norm: empty input {tuple(x.shape)}")
    if c % 32 != 0 or c % num_groups != 0:
        raise ValueError(f"group_norm: C={c} must be divisible by 32 and by num_groups={num_groups}")
    if c * x.element_size() // 16 > _MAX_VECTORS_PER_ROW or c // num_groups > _MAX_GROUP_CHANNELS:
        raise ValueError(f"group_norm: C={c} in {num_groups} groups is too wide for the kernel")
    if not x.is_contiguous():
        raise ValueError("group_norm: x must be contiguous NHWC (a channels_last NCHW "
                         "tensor permuted to NHWC)")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("group_norm is forward-only; call it under torch.no_grad() "
                           "or torch.inference_mode()")


def _check_affine(x: torch.Tensor, *vecs: torch.Tensor) -> None:
    c = x.shape[-1]
    for v in vecs:
        if v.shape != (c,):
            raise ValueError(f"group_norm: affine vector of shape {tuple(v.shape)}, expected ({c},)")
        if v.device != x.device:
            raise ValueError(f"group_norm: affine vector on {v.device}, x on {x.device}")
        if torch.is_grad_enabled() and v.requires_grad:
            raise RuntimeError("group_norm is forward-only; call it under torch.no_grad() "
                               "or torch.inference_mode()")


def _check_aligned(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("group_norm: the CUDA kernel needs 16-byte aligned tensors")


# ---------------------------------------------------------------------------
# plain versions (PyTorch ops; the CPU path and the kernels' yardstick)
# ---------------------------------------------------------------------------

def group_norm_stats_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                           num_groups: int = 32, eps: float = 1e-5):
    """(Σx [B,C] f32, Σx² [B,C] f32, mul [B,C] x.dtype, add [B,C] x.dtype)."""
    b, h, w, c = x.shape
    g, cg = num_groups, c // num_groups
    s_c, s2_c = sums_and_squares(x.to(torch.float32), (1, 2))
    n = float(h * w * cg)
    mu = s_c.reshape(b, g, cg).sum(-1) / n
    var = torch.clamp(s2_c.reshape(b, g, cg).sum(-1) / n - mu * mu, min=0.0)
    inv = torch.rsqrt(var + eps)
    mu_c = mu.repeat_interleave(cg, dim=1)
    inv_s = inv.repeat_interleave(cg, dim=1) * scale.to(torch.float32)[None]
    mul = inv_s.to(x.dtype)
    add = (bias.to(torch.float32)[None] - mu_c * inv_s).to(x.dtype)
    return s_c, s2_c, mul, add


def group_norm_apply_plain(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """y = x·mul + add in x.dtype, mul/add [B, C] broadcast over H, W."""
    return x * mul[:, None, None, :] + add[:, None, None, :]


def group_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    _, _, mul, add = group_norm_stats_plain(x, scale, bias, num_groups, eps)
    return group_norm_apply_plain(x, mul, add)


# ---------------------------------------------------------------------------
# wrappers: kernel on CUDA tensors, plain version on CPU tensors
# ---------------------------------------------------------------------------

def group_norm_stats(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     num_groups: int = 32, eps: float = 1e-5):
    """B2a: per-channel sums and the folded per-(image, channel) mul/add."""
    _check_x(x, num_groups)
    _check_affine(x, scale, bias)
    if native.on_cpu(x):
        return group_norm_stats_plain(x, scale, bias, num_groups, eps)
    b, h, w, c = x.shape
    hw = h * w
    # about two blocks per SM over the whole batch, at least 32 rows each
    rows = max(32, -(-(b * hw) // (2 * native.sm_count(x.device.index))))
    n_chunks = -(-hw // rows)
    # one f32 buffer: partials [2, b, n_chunks, c], then Σx [b, c], Σx² [b, c];
    # one x.dtype buffer: mul [b, c], add [b, c] (every piece 16-byte aligned)
    n_part = 2 * b * n_chunks * c
    f32 = torch.empty(n_part + 2 * b * c, device=x.device, dtype=torch.float32)
    sums, sumsq = f32[n_part:].view(2, b, c).unbind(0)
    mul, add = torch.empty((2, b, c), device=x.device, dtype=x.dtype).unbind(0)
    scale = scale.to(torch.float32).contiguous()
    bias = bias.to(torch.float32).contiguous()
    _check_aligned(x)
    err = native.launch(x, _lib().gn_stats, native.DTYPE_CODES[x.dtype], x.data_ptr(), b, hw,
                        c, num_groups, rows, n_chunks, float(hw * (c // num_groups)), eps,
                        scale.data_ptr(), bias.data_ptr(), f32.data_ptr(), sums.data_ptr(),
                        sumsq.data_ptr(), mul.data_ptr(), add.data_ptr())
    if err:
        raise RuntimeError(f"gn_stats kernel launch failed: CUDA error {err}")
    launches["group_norm_stats"] += 1
    return sums, sumsq, mul, add


def group_norm_apply(x: torch.Tensor, mul: torch.Tensor, add: torch.Tensor) -> torch.Tensor:
    """B2b: y = x·mul + add in x.dtype."""
    _check_x(x, 32)
    b, _, _, c = x.shape
    for v in (mul, add):
        if v.shape != (b, c) or v.dtype != x.dtype or v.device != x.device or not v.is_contiguous():
            raise ValueError(f"group_norm_apply: mul/add must be contiguous ({b}, {c}) "
                             f"{x.dtype} on {x.device}")
    if native.on_cpu(x):
        return group_norm_apply_plain(x, mul, add)
    y = torch.empty_like(x)
    _check_aligned(x, mul, add, y)
    n_vec = x.numel() * x.element_size() // 16
    n_blocks = min(-(-n_vec // _APPLY_THREADS), 16 * native.sm_count(x.device.index))
    err = native.launch(x, _lib().gn_apply, native.DTYPE_CODES[x.dtype], x.data_ptr(),
                        mul.data_ptr(), add.data_ptr(), y.data_ptr(), x.numel(), c,
                        x.numel() // b, n_blocks)
    if err:
        raise RuntimeError(f"gn_apply kernel launch failed: CUDA error {err}")
    launches["group_norm_apply"] += 1
    return y


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm of NHWC ``x`` with f32 per-channel ``scale``/``bias``.

    Same function as ``diga_tpu.ops.pallas_gn.group_norm_pallas`` and
    ``FusedGroupNorm``: stats in f32, normalization in x.dtype.
    """
    _, _, mul, add = group_norm_stats(x, scale, bias, num_groups, eps)
    return group_norm_apply(x, mul, add)
