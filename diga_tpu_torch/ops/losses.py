"""Segmentation and distillation losses on NHWC logits.

Counterpart of ``diga_tpu/ops/losses.py`` (:19-105).  Logits are NHWC,
labels (B, H, W) integer trainIds with 255 = ignore.  Reference
semantics:
  * ``cross_entropy2d``  — util/loss.py:48-62: the NLL of the valid pixels
    summed, divided by the count of ALL pixels, ignored ones included
    (``F.cross_entropy(ignore_index=255)`` would divide by the valid count);
    ``cross_entropy2d_valid_mean`` divides by the valid count
  * ``ohem_cross_entropy`` — util/loss.py:65-122, the SYNTHIA stages' loss
  * ``distillation_loss`` — util/loss.py:125-143, written with autograd
    through PyTorch ops.  The train step runs the same function as
    ``ops.distill.distillation_loss``, whose backward is a CUDA kernel.

The translator stage's losses (``diga_tpu/ops/losses.py:108-166``) take
NCHW images, the translator's layout: ``l1_loss``, the multi-scale LSGAN
``lsgan_d_loss``/``lsgan_g_loss``, and ``seg_edge_loss`` over the 5x5
``laplacian2d``.  All compute in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import dist

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


def cross_entropy2d_valid_mean(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """CE averaged over the valid pixels only (the textbook normalization), f32."""
    nll, valid = _nll_map(logits, labels)
    return torch.sum(nll) / torch.clamp(valid.sum(), min=1)


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, thresh: float = 0.7,
                       min_kept: int = 100_000) -> torch.Tensor:
    """Online hard-example mining CE, f32: the mean NLL of the valid pixels
    whose probability of the true class is below max(``thresh``, the
    probability of the ``min(min_kept, n_valid - 1)``-th least likely valid
    pixel); a non-finite such probability (no valid pixel) counts as 0, and
    the mean is over at least one pixel.  The kept set carries no gradient.
    The selection sorts on the device: no host synchronisation.

    Under a process group the selection is over the global batch, as the
    JAX step's over its mesh: the threshold comes from every rank's
    probabilities gathered, and the local kept sum is scaled by world /
    the global kept count, so the ranks' average is the global mean."""
    nll, valid = _nll_map(logits, labels)
    nll, valid = nll.reshape(-1), valid.reshape(-1)
    prob = torch.exp(-nll.detach())
    masked = torch.where(valid, prob, torch.full_like(prob, torch.inf))
    ranked = torch.sort(dist.gather_rows(masked)).values
    n_valid = torch.isfinite(ranked).sum() if dist.active() else valid.sum()
    k = torch.clamp(torch.clamp(n_valid - 1, min=0), max=min_kept)
    min_value = ranked.gather(0, k.reshape(1))[0]
    min_value = torch.where(torch.isfinite(min_value), min_value, torch.zeros_like(min_value))
    keep = valid & (prob < torch.clamp(min_value, min=thresh))
    total = torch.sum(torch.where(keep, nll, torch.zeros_like(nll)))
    if dist.active():
        return total * dist.world() / torch.clamp(dist.all_reduce_sum(keep.sum()), min=1)
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


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a.to(torch.float32) - b.to(torch.float32)))


def lsgan_d_loss(real_scores: list[torch.Tensor], fake_scores: list[torch.Tensor]) -> torch.Tensor:
    """LSGAN discriminator loss summed over the scales: MSE to 1 on the
    real patch scores, to 0 on the fake (train_domain_translator.py:262-282)."""
    loss = 0.0
    for r, f in zip(real_scores, fake_scores):
        loss = loss + torch.mean((r.to(torch.float32) - 1.0) ** 2)
        loss = loss + torch.mean(f.to(torch.float32) ** 2)
    return loss


def lsgan_g_loss(fake_scores: list[torch.Tensor]) -> torch.Tensor:
    """LSGAN generator loss: MSE to 1 on the fake patch scores."""
    loss = 0.0
    for f in fake_scores:
        loss = loss + torch.mean((f.to(torch.float32) - 1.0) ** 2)
    return loss


def laplacian2d(x: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """kornia's laplacian as ``seg_edge_loss`` uses it (util/loss.py:217,222):
    a per-channel (depthwise) ``ksize``² kernel of ones with centre
    1 − ksize², over a reflect-padded NCHW ``x``."""
    c = x.shape[1]
    k = torch.ones((ksize, ksize), dtype=x.dtype, device=x.device)
    k[ksize // 2, ksize // 2] = 1.0 - ksize * ksize
    pad = ksize // 2
    xp = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    with torch.autocast(x.device.type, enabled=False):  # in x's dtype, as in JAX
        return F.conv2d(xp, k.expand(c, 1, ksize, ksize), groups=c)


def seg_edge_loss(rgb_out: torch.Tensor, rgb_in: torch.Tensor, segm: torch.Tensor) -> torch.Tensor:
    """L1 between the input and translated images on the semantic edges of
    ``segm`` (B, H, W) (util/loss.py:206-229); NCHW images."""
    seg = segm.to(torch.float32)[:, None]
    edges = (torch.abs(laplacian2d(seg)) > 0.1).to(torch.float32).expand_as(rgb_in)
    return l1_loss(rgb_in * edges, rgb_out * edges)
