"""Symmetric distillation loss: hand-written CUDA ``autograd.Function`` + plain version.

Counterpart of ``diga_tpu/ops/pallas_kernels.py::distillation_loss_pallas``,
the Pallas pair ``_fwd_kernel`` (B1a) and ``_bwd_kernel`` (B1b), and the
same function as ``diga_tpu/ops/losses.py::distillation_loss``: the
[clean; augmented] logit stacks of teacher and student, teacher soft
targets from one view supervising the student's other view, the
augmented->clean direction weighted by ``scale``.

``distillation_loss(t, s, scale)`` takes the JAX layout: contiguous NHWC
tensors of shape (2B, H, W, K), i.e. the model's channels_last NCHW logits
(upsampled by ``resize_bilinear``) permuted to NHWC, a view with no copy.
Any other layout raises.  On CUDA tensors it launches the kernels of
``diga_tpu_torch/csrc/distill.cu`` or raises; on CPU tensors it runs the
plain versions, which repeat the kernels' arithmetic with PyTorch ops.
The loss is an f32 scalar that stays on the device; the backward
recomputes both softmaxes from the logits, reads the incoming gradient from
device memory, and writes the student's gradient in its dtype.  The
teacher gets no gradient (``None``).

Each wrapper adds one to ``launches[<name>]`` when it launches its kernel;
the forward issues two launches (per-block partials, then the ordered
fold) per call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import native

launches = {"distill_loss": 0, "distill_grad": 0}

MAX_CLASSES = 32  # the kernel keeps a row of K logits in registers
_THREADS = 256
_BLOCKS_PER_SM = 16


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = native.load("distill")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    lib.distill_loss.argtypes = [i, p, p, ll, i, f, i, p, p, p]
    lib.distill_loss.restype = i
    lib.distill_grad.argtypes = [i, p, p, p, ll, i, f, f, i, p, p]
    lib.distill_grad.restype = i
    return lib


def _check(t: torch.Tensor, s: torch.Tensor) -> None:
    if t.dim() != 4 or t.shape != s.shape:
        raise ValueError(f"distillation_loss: expected equal NHWC shapes (2B, H, W, K), "
                         f"got {tuple(t.shape)} and {tuple(s.shape)}")
    n2, h, w, k = t.shape
    if n2 % 2 or n2 * h * w == 0:
        raise ValueError(f"distillation_loss: the batch must be a non-empty [clean; aug] "
                         f"stack of even size, got {tuple(t.shape)}")
    if not 1 <= k <= MAX_CLASSES:
        raise ValueError(f"distillation_loss: K={k} classes, the kernel takes 1..{MAX_CLASSES}")
    if t.dtype not in native.DTYPE_CODES or s.dtype != t.dtype:
        raise TypeError(f"distillation_loss: teacher and student must share dtype float32 or "
                        f"bfloat16, got {t.dtype} and {s.dtype}")
    if t.device != s.device:
        raise ValueError(f"distillation_loss: teacher on {t.device}, student on {s.device}")
    if not (t.is_contiguous() and s.is_contiguous()):
        raise ValueError("distillation_loss: logits must be contiguous NHWC (channels_last "
                         "NCHW logits permuted to NHWC)")


# ---------------------------------------------------------------------------
# plain versions (PyTorch ops; the CPU path and the kernels' yardstick)
# ---------------------------------------------------------------------------

def _ce_sum(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Σ over pixels of Σ_k −softmax(t)·log_softmax(s), in f32."""
    q = torch.softmax(t.to(torch.float32), dim=-1)
    ls = torch.log_softmax(s.to(torch.float32), dim=-1)
    return torch.sum(-q * ls)


def distillation_loss_plain(t: torch.Tensor, s: torch.Tensor, scale: float) -> torch.Tensor:
    """The loss value: Σ CE(t_clean, s_aug)/npix + Σ CE(t_aug, s_clean)/npix·scale."""
    b = t.shape[0] // 2
    npix = b * t.shape[1] * t.shape[2]
    t0 = _ce_sum(t[:b], s[b:]) / npix
    t1 = _ce_sum(t[b:], s[:b]) / npix * scale
    return t0 + t1


def distillation_grad_plain(t: torch.Tensor, s: torch.Tensor, g: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """d loss / d s in s's dtype, both halves written into one buffer."""
    b = t.shape[0] // 2
    npix = b * t.shape[1] * t.shape[2]
    g = g.to(torch.float32)

    def half(th, sh, coeff):
        d = torch.softmax(sh.to(torch.float32), dim=-1) - torch.softmax(th.to(torch.float32), dim=-1)
        return d * (g * coeff)

    ds = torch.empty_like(s)
    ds[b:] = half(t[:b], s[b:], 1.0 / npix)      # teacher clean -> student aug
    ds[:b] = half(t[b:], s[:b], scale / npix)    # teacher aug -> student clean
    return ds


# ---------------------------------------------------------------------------
# kernels (CUDA tensors)
# ---------------------------------------------------------------------------

def _n_blocks(t: torch.Tensor, npix: int) -> int:
    return min(-(-npix // _THREADS), _BLOCKS_PER_SM * native.sm_count(t.device.index))


def distillation_loss_kernel(t: torch.Tensor, s: torch.Tensor, scale: float) -> torch.Tensor:
    """B1a: the loss as an f32 scalar on the device (two launches)."""
    n2, h, w, k = t.shape
    npix = n2 // 2 * h * w
    n_blocks = _n_blocks(t, npix)
    part = torch.empty(2 * n_blocks, device=t.device, dtype=torch.float32)
    out = torch.empty((), device=t.device, dtype=torch.float32)
    err = native.launch(t, _lib().distill_loss, native.DTYPE_CODES[t.dtype], t.data_ptr(),
                        s.data_ptr(), npix, k, float(scale), n_blocks, part.data_ptr(),
                        out.data_ptr())
    if err:
        raise RuntimeError(f"distill_loss kernel launch failed: CUDA error {err}")
    launches["distill_loss"] += 1
    return out


def distillation_grad_kernel(t: torch.Tensor, s: torch.Tensor, g: torch.Tensor,
                             scale: float) -> torch.Tensor:
    """B1b: d loss / d s in s's dtype, g read from device memory."""
    n2, h, w, k = t.shape
    npix = n2 // 2 * h * w
    g = g.to(device=t.device, dtype=torch.float32).contiguous()
    if g.numel() != 1:
        raise ValueError(f"distill_grad: expected a scalar incoming gradient, got {tuple(g.shape)}")
    ds = torch.empty_like(s)
    err = native.launch(t, _lib().distill_grad, native.DTYPE_CODES[t.dtype], t.data_ptr(),
                        s.data_ptr(), g.data_ptr(), npix, k, float(scale / npix),
                        float(1.0 / npix), _n_blocks(t, npix), ds.data_ptr())
    if err:
        raise RuntimeError(f"distill_grad kernel launch failed: CUDA error {err}")
    launches["distill_grad"] += 1
    return ds


class DistillationLoss(torch.autograd.Function):
    """forward(teacher_logits, student_logits, scale) -> f32 scalar;
    backward -> (None, d student, None).  Saves the logits themselves and
    recomputes the softmaxes, as the JAX custom VJP does."""

    @staticmethod
    def forward(ctx, teacher_logits, student_logits, scale):
        _check(teacher_logits, student_logits)
        ctx.save_for_backward(teacher_logits, student_logits)
        ctx.scale = scale
        if native.on_cpu(teacher_logits):
            return distillation_loss_plain(teacher_logits, student_logits, scale)
        return distillation_loss_kernel(teacher_logits, student_logits, scale)

    @staticmethod
    def backward(ctx, g):
        t, s = ctx.saved_tensors
        if native.on_cpu(t):
            ds = distillation_grad_plain(t, s, g, ctx.scale)
        else:
            ds = distillation_grad_kernel(t, s, g, ctx.scale)
        return None, ds, None


def distillation_loss(teacher_logits: torch.Tensor, student_logits: torch.Tensor,
                      scale: float = 0.5) -> torch.Tensor:
    """Symmetric cross-view distillation of NHWC (2B, H, W, K) logit stacks."""
    return DistillationLoss.apply(teacher_logits, student_logits, scale)
