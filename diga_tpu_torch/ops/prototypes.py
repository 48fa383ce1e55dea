"""Class prototypes (feature centroids) and bilateral-consensus selection.

Counterpart of ``diga_tpu/ops/prototypes.py`` (:29-146), the reference
``Class_Features`` (calc_centroids.py:84-180) as fixed-shape tensor ops:

  * masked per-class feature means: a one-hot product and a count divide
    (reference :120-145)
  * count-gated mean/EMA centroid updates, applied image by image in batch
    order as the reference does (reference :147-164)
  * the centroid distance as |f|^2 + |c|^2 - 2 f.c (reference :166-171)
  * threshold-free bilateral consensus (reference
    train_DiGA_gta2city_self_training.py:297-304)

The JAX package computes these in f32 at ``Precision.HIGHEST``.  Here they
run in f32 with autocast disabled, whatever the caller's autocast: inside
the train step's bf16 region the products would otherwise run in bf16 and
move the consensus.  (A CUDA f32 matmul is full f32 unless the caller
turned TF32 on, which the port never does.)  Argmax ties resolve to the
first index, as in JAX.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .resize import resize_nearest

IGNORE = 255


@dataclasses.dataclass
class Centroids:
    """Objective vectors (K, C) f32 and per-class observation counts (K,) f32."""

    vectors: torch.Tensor
    counts: torch.Tensor

    @classmethod
    def create(cls, num_classes: int, feat_dim: int,
               device: torch.device | str = "cpu") -> "Centroids":
        return cls(vectors=torch.zeros((num_classes, feat_dim), device=device),
                   counts=torch.zeros((num_classes,), device=device))


def _f32(fn):
    """Run ``fn`` with autocast off on its first tensor's device (its tensor
    inputs are cast to f32 inside)."""

    @functools.wraps(fn)
    def wrapped(first, *args, **kwargs):
        device = (first.vectors if isinstance(first, Centroids) else first).device
        with torch.autocast(device.type, enabled=False):
            return fn(first, *args, **kwargs)

    return wrapped


def _one_hot(ids: torch.Tensor, k: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(ids.to(torch.int64), k).to(torch.float32)


@_f32
def masked_class_means(feat: torch.Tensor, logits: torch.Tensor,
                       labels: torch.Tensor | None = None,
                       min_pixels: int = 5) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-image per-class masked feature means.

    feat: (B, h, w, C); logits: (B, h, w, K); labels: (B, H, W) or None.
    Returns (vectors (B, K, C) f32, valid (B, K) bool).  The class mask is
    the one-hot of the prediction argmax, ANDed with the one-hot of the
    nearest-downsampled labels where given; a class with fewer than
    ``min_pixels`` pixels, or whose mean is all zeros, is invalid
    (reference calc_centroids.py:120-148).
    """
    b, h, w, c = feat.shape
    k = logits.shape[-1]
    mask = _one_hot(torch.argmax(logits, dim=-1), k)  # (B, h, w, K)
    if labels is not None:
        lbl = resize_nearest(labels, (h, w))
        mask = mask * _one_hot(torch.where(lbl == IGNORE, k, lbl), k + 1)[..., :k]
    flat_mask = mask.reshape(b, h * w, k)
    sums = torch.einsum("bpk,bpc->bkc", flat_mask, feat.to(torch.float32).reshape(b, h * w, c))
    counts = flat_mask.sum(dim=1)  # (B, K)
    vectors = sums / torch.clamp(counts, min=1.0)[..., None]
    valid = (counts >= min_pixels) & (vectors.abs().sum(dim=-1) > 0)
    return vectors, valid


@_f32
def update_centroids(cent: Centroids, vectors: torch.Tensor, valid: torch.Tensor,
                     momentum: float = 1e-4, start_mean: bool = True,
                     count_cap: float = 3000.0) -> Centroids:
    """Count-gated centroid update, image by image: image 0's classes before
    image 1's (reference calc_centroids.py:147-164).  A running mean for the
    first 100 observations of a class when ``start_mean``, else the EMA."""
    vecs, counts = cent.vectors, cent.counts
    for v, ok in zip(vectors.to(torch.float32), valid):
        okf = ok.to(torch.float32)
        mean_upd = (vecs * counts[:, None] + v) / (counts[:, None] + 1.0)
        ema_upd = vecs * (1.0 - momentum) + momentum * v
        new = torch.where((counts < 100.0)[:, None], mean_upd, ema_upd) if start_mean else ema_upd
        vecs = vecs + okf[:, None] * (new - vecs)
        counts = torch.clamp(counts + okf, max=count_cap)
    return Centroids(vectors=vecs, counts=counts)


@_f32
def centroid_distance(feat: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Euclidean distance map (B, h, w, K) from each feature to each centroid
    (reference feat_centroid_distance, :166-171)."""
    f = feat.to(torch.float32)
    c = centroids.to(torch.float32)
    f2 = (f * f).sum(dim=-1, keepdim=True)
    c2 = (c * c).sum(dim=-1)
    cross = torch.einsum("bhwc,kc->bhwk", f, c)
    return torch.sqrt(torch.clamp(f2 + c2 - 2.0 * cross, min=0.0))


@_f32
def centroid_weight(feat: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """softmax(-distance) over classes (reference get_centroid_weight, :173-176)."""
    return torch.softmax(-centroid_distance(feat, centroids), dim=-1)


def bilateral_consensus(pseudo: torch.Tensor, feat_weight_up: torch.Tensor) -> torch.Tensor:
    """The pseudo-label where it equals the nearest-prototype label, else 255
    (reference self_training.py:297-304); ``feat_weight_up`` is
    ``centroid_weight`` upsampled to the label's resolution."""
    proto = torch.argmax(feat_weight_up, dim=-1).to(pseudo.dtype)
    return torch.where(pseudo == proto, pseudo, torch.full_like(pseudo, IGNORE))
