"""Segmentation and distillation losses on NHWC logits.

Counterpart of ``diga_tpu/ops/losses.py`` (:19-71).  Logits are NHWC,
labels (B, H, W) integer trainIds with 255 = ignore.  Reference
semantics:
  * ``cross_entropy2d``  — util/loss.py:48-62: the NLL of the valid pixels
    summed, divided by the count of ALL pixels, ignored ones included
    (``F.cross_entropy(ignore_index=255)`` would divide by the valid count)
  * ``distillation_loss`` — util/loss.py:125-143, written with autograd
    through PyTorch ops.  The train step runs the same function as
    ``ops.distill.distillation_loss``, whose backward is a CUDA kernel.
"""

from __future__ import annotations

import torch

IGNORE = 255


def cross_entropy2d(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Masked 2D cross entropy, f32, divided by ``labels.numel()``."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    valid = labels != IGNORE
    ids = torch.where(valid, labels, torch.zeros_like(labels)).to(torch.int64)
    nll = -torch.gather(logp, -1, ids[..., None])[..., 0]
    return torch.sum(torch.where(valid, nll, torch.zeros_like(nll))) / labels.numel()


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
