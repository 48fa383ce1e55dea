"""A BatchNorm whose training statistics are over the global batch.

The counterpart of the JAX ``BatchNorm2D`` (``diga_tpu/models/norms.py``)
under a data mesh, where GSPMD reduces its statistics over every device.
``torch.nn.SyncBatchNorm`` cannot stand in: it raises on a CPU tensor and
at world size 1 it runs plain ``batch_norm`` without a collective, so
neither the CPU tests nor a one-card run would exercise it.

``SyncBatchNorm2d`` is an ``nn.BatchNorm2d`` (same parameters, buffers and
state_dict keys; the frozen affine keeps ``requires_grad=False``).  In
training under a process group it computes per-channel Σx, Σx² and the
element count with f32 accumulators over x as it is (no f32 copy of x),
sums them over the ranks, normalizes with the biased variance E[x²]−E[x]²
in x's dtype, and moves the running statistics by momentum 0.1 towards
the mean and the unbiased variance over the global count: ``norms.py``'s
formulas.  Its backward (``_SyncBatchNormFn``) sums Σdy and Σdy·x over
the ranks, since every rank's loss depends on every rank's statistics.  Under a group it always takes this path, at
world size 1 too.  In eval mode, or with no group, it is
``nn.BatchNorm2d``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from . import dist


def _channel(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-channel f32 vector as a (1, C, 1, 1) tensor in ``like``'s dtype."""
    return v.to(like.dtype).view(1, -1, 1, 1)


class _SyncBatchNormFn(torch.autograd.Function):
    """y = (x − μ)·σ⁻¹·w + b over the global batch, with its backward.

    Forward: Σx and Σx² with f32 accumulators over x as it is, summed over
    the ranks with the element count; the biased variance E[x²]−E[x]²
    normalizes, the running statistics move towards the mean and the
    unbiased variance; y in x's dtype, one pass (``addcmul``).
    Backward: Σdy and Σdy·x (f32 accumulators) summed over the ranks, then
    dx = a·dy + b·x + c per channel, with a = w·σ⁻¹, b = −a·σ⁻²·S/n,
    c = −a·Σdy/n − b·μ, S = Σdy·x − μ·Σdy: every rank's loss depends on
    every rank's statistics.  The affine gradients are this rank's sums;
    ``all_reduce_grads`` averages them with every other gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, bn):
        c, dims = x.shape[1], (0, 2, 3)
        # the norm's square is Σx² summed in f32
        local = torch.cat([torch.sum(x, dim=dims, dtype=torch.float32),
                           torch.linalg.vector_norm(x, 2, dim=dims, dtype=torch.float32) ** 2,
                           x.new_full((1,), float(x.numel() // c), dtype=torch.float32)])
        stats = dist.all_reduce_sum(local)
        n = stats[2 * c]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
        if bn.track_running_stats:
            bn.running_mean.lerp_(mean, bn.momentum)
            bn.running_var.lerp_(var * (n / torch.clamp(n - 1.0, min=1.0)), bn.momentum)
            bn.num_batches_tracked.add_(1)
        invstd = torch.rsqrt(var + bn.eps)
        scale = invstd if weight is None else invstd * weight
        shift = -mean * scale if bias is None else bias - mean * scale
        ctx.save_for_backward(x, mean, invstd, scale, n)
        ctx.affine = weight is not None
        # the scale-and-shift in x's dtype, as the JAX BatchNorm2D applies it
        return torch.addcmul(_channel(shift, x), x, _channel(scale, x))

    @staticmethod
    def backward(ctx, dy):
        x, mean, invstd, a, n = ctx.saved_tensors
        c, dims = x.shape[1], (0, 2, 3)
        dy = dy.contiguous(memory_format=torch.channels_last
                           if x.is_contiguous(memory_format=torch.channels_last)
                           else torch.contiguous_format)
        local = torch.cat([torch.sum(dy, dim=dims, dtype=torch.float32),
                           torch.sum(dy * x, dim=dims, dtype=torch.float32)])
        sums = dist.all_reduce_sum(local)
        s_dy = sums[:c]
        s = sums[c:] - mean * s_dy
        b = -a * invstd * invstd * s / n
        cc = -a * s_dy / n - b * mean
        dx = torch.addcmul(torch.addcmul(_channel(cc, x), x, _channel(b, x)), dy, _channel(a, x))
        dw = db = None
        if ctx.affine and ctx.needs_input_grad[1]:
            dw = (local[c:] - mean * local[:c]) * invstd
        if ctx.affine and ctx.needs_input_grad[2]:
            db = local[:c]
        return dx, dw, db, None


class SyncBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with its training statistics over every rank's batch."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and dist.active()):
            return super().forward(x)
        return _SyncBatchNormFn.apply(x, self.weight, self.bias, self)


def convert_sync_bn(model: nn.Module) -> nn.Module:
    """Make every ``nn.BatchNorm2d`` of ``model`` a ``SyncBatchNorm2d`` in
    place (the same object, its class swapped: parameters, buffers,
    ``requires_grad`` and state_dict keys unchanged), but only under a
    process group; without one the model stays as it is."""
    if dist.active():
        for m in model.modules():
            if type(m) is nn.BatchNorm2d:
                m.__class__ = SyncBatchNorm2d
    return model
