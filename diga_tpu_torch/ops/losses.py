"""Segmentation and distillation losses on NHWC logits.

Counterpart of ``diga_tpu/ops/losses.py`` (:19-105).  Logits are NHWC,
labels (B, H, W) integer trainIds with 255 = ignore.  Reference
semantics:
  * ``cross_entropy2d``  — util/loss.py:48-62: the NLL of the valid pixels
    summed, divided by the count of ALL pixels, ignored ones included
    (``F.cross_entropy(ignore_index=255)`` would divide by the valid count)
  * ``ohem_cross_entropy`` — util/loss.py:65-122, the SYNTHIA stages' loss
  * ``distillation_loss`` — util/loss.py:125-143, written with autograd
    through PyTorch ops.  The train step runs the same function as
    ``ops.distill.distillation_loss``, whose backward is a CUDA kernel.
"""

from __future__ import annotations

import torch

IGNORE = 255


def _nll_map(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel f32 NLL of the true class (0 where ignored) and the valid mask."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    valid = labels != IGNORE
    ids = torch.where(valid, labels, torch.zeros_like(labels)).to(torch.int64)
    nll = -torch.gather(logp, -1, ids[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)), valid


def cross_entropy2d(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Masked 2D cross entropy, f32, divided by ``labels.numel()``."""
    nll, _ = _nll_map(logits, labels)
    return torch.sum(nll) / labels.numel()


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, thresh: float = 0.7,
                       min_kept: int = 100_000) -> torch.Tensor:
    """Online hard-example mining CE, f32: the mean NLL of the valid pixels
    whose probability of the true class is below max(``thresh``, the
    probability of the ``min(min_kept, n_valid - 1)``-th least likely valid
    pixel); a non-finite such probability (no valid pixel) counts as 0, and
    the mean is over at least one pixel.  The kept set carries no gradient.
    The selection sorts on the device: no host synchronisation."""
    nll, valid = _nll_map(logits, labels)
    nll, valid = nll.reshape(-1), valid.reshape(-1)
    prob = torch.exp(-nll.detach())
    ranked = torch.sort(torch.where(valid, prob, torch.full_like(prob, torch.inf))).values
    n_valid = valid.sum()
    k = torch.clamp(torch.clamp(n_valid - 1, min=0), max=min_kept)
    min_value = ranked.gather(0, k.reshape(1))[0]
    min_value = torch.where(torch.isfinite(min_value), min_value, torch.zeros_like(min_value))
    keep = valid & (prob < torch.clamp(min_value, min=thresh))
    total = torch.sum(torch.where(keep, nll, torch.zeros_like(nll)))
    return total / torch.clamp(keep.sum(), min=1)


def distillation_loss(teacher_logits: torch.Tensor, student_logits: torch.Tensor,
                      scale: float = 0.5) -> torch.Tensor:
    """Symmetric cross-view distillation of [clean; aug] (2B, H, W, K) stacks:
    teacher clean -> student aug (weight 1), teacher aug -> student clean
    (weight ``scale``); the teacher is stop-gradient."""
    q = torch.softmax(teacher_logits.detach().to(torch.float32), dim=-1)
    logp = torch.log_softmax(student_logits.to(torch.float32), dim=-1)
    b = teacher_logits.shape[0] // 2
    t0 = torch.mean(torch.sum(-q[:b] * logp[b:], dim=-1))
    t1 = torch.mean(torch.sum(-q[b:] * logp[:b], dim=-1)) * scale
    return t0 + t1
