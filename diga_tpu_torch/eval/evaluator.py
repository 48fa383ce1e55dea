"""Two-scale max-merge evaluation, on one device or batch-sharded over ranks.

Counterpart of ``diga_tpu/eval/evaluator.py`` (:27-39 and
``TwoScaleEvaluator``).  Protocol (reference: evaluate_val.py:73-93):
  1. forward the full-resolution image
  2. forward a bilinear (align_corners=True) downscale (e.g. 512x1024)
  3. upsample both logit maps to label resolution (align_corners=True)
  4. elementwise max-merge, argmax
  5. accumulate the confusion matrix on the device

Tensors at this surface are NHWC, as in the JAX package.

Batch-sharded over a process group (``diga_tpu/eval/evaluator.py:55-113``):
``iter_val(..., rank, world)`` gives rank r its ``batch`` images of every
eval batch of ``world`` x ``batch``, the tail padded as one process pads
it, and ``RunningScore.get_scores`` sums the int64 confusion matrix over
the ranks, so every rank gets the one-process mIoU exactly.

Height-sharded (``shard="spatial"``, ``diga_tpu/eval/evaluator.py:55-66``;
the row layout of ``parallel/spatial.py``): every shard is given the whole
image and label and keeps its rows of them (the height must divide by the
shards), the model's sharded modules and the three resizes of
``two_scale_logits`` compute its rows of the logits, argmax is local, and
each image's confusion counts over the shard's label rows are summed over
the shards (int64), so every shard holds the one-process matrix.

``update`` runs in spans (``utils/profiling.py::span``): one
``eval_update`` around ``h2d`` (the image's and label's host-to-device
copies), the model's forwards (named after its class by the caller's
``apply_fn``, ``train/build.py::_eval_apply``), each of the three
``resize`` calls, ``merge_argmax`` and ``confusion``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.metrics import RunningScore, confusion_update, scores_from_confusion
from ..ops.resize import resize_bilinear
from ..parallel import spatial as spatial_mod
from ..parallel import spatial_ops
from ..utils.profiling import span


def iter_val(ds, limit=None, batch=1, rank: int = 0, world: int = 1):
    """Fixed-shape batches of ``batch`` images from a val dataset: rank
    ``rank``'s rows of every eval batch of ``world`` x ``batch`` images.
    The final partial batch is padded by repeating the last image with
    all-ignore (255) labels, which contribute nothing to the confusion
    matrix; ``names`` lists only the real entries of the rank's rows, and
    ``valid`` counts them, so prediction dumps skip the padding."""
    n = len(ds) if limit is None else min(limit, len(ds))
    step = batch * world
    for start in range(0, n, step):
        lo = start + rank * batch
        samples = [ds[i] for i in range(min(lo, n), min(lo + batch, n))]
        k = len(samples)
        if not samples:  # this rank's rows are all padding
            samples = [ds[n - 1]]
        images = [s["image"] for s in samples]
        labels = [s["label"].astype(np.int32) for s in samples]
        if k == 0:
            labels = [np.full_like(labels[0], 255)]
        while len(images) < batch:
            images.append(images[-1])
            labels.append(np.full_like(labels[-1], 255))
        yield {"image": np.stack(images), "label": np.stack(labels),
               "names": [s["name"] for s in samples[:k]], "valid": k}


def _resize(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``resize_bilinear`` of NHWC ``x``; in a height-sharded eval ``x`` is
    this shard's rows, ``out_hw`` the whole size, and the result its rows."""
    shard = spatial_mod.current()
    with span("resize"):
        if shard is None:
            return resize_bilinear(x, out_hw)
        return spatial_ops.resize_rows(shard, x.permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)


def _both_scales(apply_fn: Callable, image: torch.Tensor, out_hw: tuple[int, int],
                 ds_hw: tuple[int, int]) -> tuple[torch.Tensor, torch.Tensor]:
    """(upsample(f(x)), upsample(f(downscale(x)))) at out_hw (NHWC)."""
    up_full = _resize(apply_fn(image), out_hw)
    up_ds = _resize(apply_fn(_resize(image, ds_hw)), out_hw)
    return up_full, up_ds


def two_scale_logits(apply_fn: Callable, image: torch.Tensor,
                     out_hw: tuple[int, int], ds_hw: tuple[int, int]) -> torch.Tensor:
    """max(upsample(f(x)), upsample(f(downscale(x)))) at out_hw (NHWC)."""
    return torch.maximum(*_both_scales(apply_fn, image, out_hw, ds_hw))


def _merge_argmax(up_full: torch.Tensor, up_ds: torch.Tensor) -> torch.Tensor:
    with span("merge_argmax"):
        return torch.argmax(torch.maximum(up_full, up_ds), dim=-1)


class _ShardScore(RunningScore):
    """The height-sharded eval's scorer: each image's counts are summed over
    the shards as it is scored, so every shard holds the whole matrix and
    scores it as it is."""

    def get_scores(self) -> tuple[dict, dict]:
        return scores_from_confusion(self.confusion.cpu().numpy())


class TwoScaleEvaluator:
    """Streaming two-scale evaluator.

    ``apply_fn(image) -> logits`` is the inference-mode model, NHWC image
    in, NHWK logits out at any stride.  ``shard``: ``'batch'`` (each
    process scores whole images) or ``'spatial'`` (the height split over
    the shards of ``spatial``, by default the process group's ranks; the
    model's convs and pools converted by ``spatial_ops.convert_spatial``).
    """

    def __init__(self, apply_fn: Callable, num_classes: int = 19,
                 out_hw: tuple[int, int] = (1024, 2048),
                 ds_hw: tuple[int, int] = (512, 1024),
                 device: torch.device | str = "cuda", shard: str = "batch",
                 spatial: spatial_mod.Shard | None = None):
        if shard not in ("batch", "spatial"):
            raise ValueError(f"shard must be 'batch' or 'spatial', got {shard!r}")
        self.apply_fn = apply_fn
        self.num_classes = num_classes
        self.out_hw = tuple(out_hw)
        self.ds_hw = tuple(ds_hw)
        self.device = torch.device(device)
        self.spatial = None
        if shard == "spatial":
            self.spatial = spatial or spatial_mod.group_shard()
            if self.out_hw[0] % self.spatial.n:
                raise ValueError(f"shard='spatial': out_hw[0] = {self.out_hw[0]} does not "
                                 f"divide by the {self.spatial.n} shards")
        self.score = (RunningScore if self.spatial is None else _ShardScore)(num_classes,
                                                                             self.device)

    def update(self, image, label) -> torch.Tensor:
        """Score one NHWC image batch against its (B, H, W) labels; returns
        the (B, H, W) predictions on the device (height-sharded: this
        shard's rows of them)."""
        if self.spatial is not None:
            return self._update_rows(image, label)
        with span("eval_update"), torch.inference_mode():
            with span("h2d"):
                image = torch.as_tensor(image).to(self.device, non_blocking=True)
                label = torch.as_tensor(label).to(self.device, non_blocking=True)
            pred = _merge_argmax(*_both_scales(self.apply_fn, image, self.out_hw, self.ds_hw))
            with span("confusion"):
                self.score.update(label, pred)
        return pred

    def _update_rows(self, image, label) -> torch.Tensor:
        shard = self.spatial
        with span("eval_update"), torch.inference_mode(), shard.active():
            with span("h2d"):
                image = shard.slice_rows(torch.as_tensor(image)).to(self.device,
                                                                    non_blocking=True)
                label = shard.slice_rows(torch.as_tensor(label)).to(self.device,
                                                                    non_blocking=True)
            pred = _merge_argmax(*_both_scales(self.apply_fn, image, self.out_hw, self.ds_hw))
            with span("confusion"):
                counts = confusion_update(torch.zeros_like(self.score.confusion), label, pred,
                                          self.num_classes)
                self.score.confusion = self.score.confusion + shard.all_reduce(counts)
        return pred
