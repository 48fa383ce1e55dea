"""The training loop: loaders -> step -> log -> eval -> export.

Counterpart of ``diga_tpu/train/loop.py`` (:40-312) on one device:
  * the dual-scale multi-stream batches (the reference's small + full
    loader pairs, train_DiGA_gta2city_warm_up.py:117-136), built by host
    threads and copied to the device each step;
  * the loop starts at ``state.step``, so a restored state resumes where
    it stopped (``diga_tpu/train/loop.py:248``);
  * in-loop two-scale eval every ``eval_every`` steps through
    ``TwoScaleEvaluator``, exporting the student/teacher to
    ``<work_dir>/weights`` on each new best mIoU, as the JAX trainer's
    ``on_best`` does (``diga_tpu/cli/train_seg.py:95-105``; reference
    :343-373), then calling the caller's ``on_best``: a run with no eval,
    or none above mIoU 0, writes no ``weights``;
  * a full-state checkpoint to ``save_path`` every ``save_every`` steps,
    written in the background and joined at the end (``:274-276,306-309``).
The caller writes the final state (``ckpt_final``).  The translator
stage's two-stream iterator is ``make_translator_iterator``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Iterator

import numpy as np
import torch

from ..configs.presets import DataConfig, ExperimentConfig, LoaderSpec
from ..data import (
    Compose,
    RandomCrop,
    RandomHorizontallyFlip,
    RandomSizedAndCrop,
    bdd_dataset,
    cityscapes_dataset,
    gta5_dataset,
    mapillary_dataset,
    synthia_dataset,
)
from ..data.loader import BatchLoader
from ..eval.evaluator import TwoScaleEvaluator, iter_val
from ..utils.checkpoint import save_train_state, wait_for_checkpoints
from ..utils.logging import MetricLogger
from .build import export_state_role_keyed, wants_target
from .state import SegTrainState


def build_dataset(spec: LoaderSpec, data_cfg: DataConfig, crop_hw, is_source: bool):
    """One stream's dataset with the stage's geometric augmentation (the
    source random-resizes, the target crops, random-resized in
    self-training; reference warm_up.py:97-103, self_training.py:110-115).
    Sources: GTA5, SYNTHIA and, for the semi-supervised stages, the labeled
    Cityscapes split; targets: Cityscapes, BDD and Mapillary.  A Cityscapes
    target stream with ``use_pseudo`` also reads the pseudo-label PNGs
    under ``<target_root>/<pseudo_dir>``.

    A Cityscapes source (``diga_tpu/train/loop.py:57-70``) reads its images
    from ``source_root``/``source_list`` and its labels from
    ``source_lbl_list``, or where that is unset (no CLI flag sets it) from
    ``target_lbl_list``, paired with the images by position, as the JAX
    package does."""
    sized = data_cfg.source_sized_crop if is_source else data_cfg.target_sized_crop
    crop_cls = RandomSizedAndCrop if sized else RandomCrop
    kw = dict(resize_hw=tuple(spec.resize_hw),
              transform=Compose([RandomHorizontallyFlip(), crop_cls(list(crop_hw))]))
    if spec.kind == "gta5":
        return gta5_dataset(data_cfg.source_root, data_cfg.source_list, **kw)
    if spec.kind == "synthia":
        return synthia_dataset(data_cfg.source_root, data_cfg.source_list, **kw)
    if spec.kind == "cityscapes" and is_source:
        return cityscapes_dataset(data_cfg.source_root, data_cfg.source_list,
                                  data_cfg.source_lbl_list or data_cfg.target_lbl_list,
                                  split=spec.split, **kw)
    if spec.kind == "cityscapes":
        if spec.use_pseudo and data_cfg.pseudo_dir is None:
            raise ValueError("a pseudo-label target stream needs --pseudo_dir")
        return cityscapes_dataset(data_cfg.target_root, data_cfg.target_img_list,
                                  data_cfg.target_lbl_list, split=spec.split,
                                  pseudo_dir=data_cfg.pseudo_dir if spec.use_pseudo else None,
                                  **kw)
    if spec.kind in ("bdd", "mapillary"):
        make = bdd_dataset if spec.kind == "bdd" else mapillary_dataset
        return make(data_cfg.target_root, data_cfg.target_img_list, data_cfg.target_lbl_list,
                    **kw)
    raise ValueError(f"unknown dataset kind {spec.kind!r}")


class MultiStreamLoader:
    """Concatenates the dual-scale streams of one domain into one batch
    (reference warm_up.py:208-230; both are cropped to the same size)."""

    def __init__(self, datasets_and_batches, seed: int, num_workers: int):
        self.loaders = [BatchLoader(ds, batch_size=b, seed=seed + 17 * i,
                                    num_workers=num_workers)
                        for i, (ds, b) in enumerate(datasets_and_batches)]

    def __iter__(self) -> Iterator[dict]:
        iters = [iter(ld) for ld in self.loaders]
        while True:
            parts = [next(it) for it in iters]
            yield {k: (sum((p[k] for p in parts), []) if k == "name"
                       else np.concatenate([p[k] for p in parts], axis=0))
                   for k in parts[0]}

    def stop(self) -> None:
        for ld in self.loaders:
            ld.stop()


def make_train_iterator(cfg: ExperimentConfig, with_target: bool):
    """(iterator of {'s_img', 's_lbl'[, 't_img', 't_lbl'[, 't_pseudo']]}
    numpy batches, the loaders to stop)."""
    crop = cfg.train.crop_hw
    src = MultiStreamLoader([(build_dataset(s, cfg.data, crop, True), s.batch)
                             for s in cfg.data.source_streams],
                            seed=cfg.train.seed, num_workers=cfg.data.num_workers)
    loaders = [src]
    tgt = None
    if with_target:
        tgt = MultiStreamLoader([(build_dataset(s, cfg.data, crop, False), s.batch)
                                 for s in cfg.data.target_streams],
                                seed=cfg.train.seed + 1000, num_workers=cfg.data.num_workers)
        loaders.append(tgt)

    def gen():
        t_it = iter(tgt) if tgt is not None else None
        for s in src:
            batch = {"s_img": s["image"], "s_lbl": s["label"]}
            if t_it is not None:
                t = next(t_it)
                batch["t_img"], batch["t_lbl"] = t["image"], t["label"]
                if "pseudo" in t:
                    batch["t_pseudo"] = t["pseudo"]
            yield batch

    return gen(), loaders


def make_translator_iterator(cfg: ExperimentConfig):
    """(iterator of {'s_img', 's_lbl', 't_img'} numpy batches, the loaders to
    stop): the translator's source and target streams, seeded as the seg
    stages' (``diga_tpu/cli/train_domain_translator.py:125-146``)."""
    it, loaders = make_train_iterator(cfg, with_target=True)
    batches = ({"s_img": b["s_img"], "s_lbl": b["s_lbl"].astype(np.int32), "t_img": b["t_img"]}
               for b in it)
    return batches, loaders


def to_device(batch: dict, device: torch.device) -> dict:
    """numpy arrays -> tensors on ``device`` (pinned, asynchronous on the card)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


@dataclasses.dataclass
class TrainLoopResult:
    best_miou: float
    best_step: int
    last_metrics: dict


def run_training(cfg: ExperimentConfig, state: SegTrainState, step_fn: Callable,
                 eval_apply: Callable | None, work_dir: str, device: torch.device,
                 num_steps: int | None = None, eval_limit: int | None = None,
                 log_every: int = 50,
                 on_best: Callable[[SegTrainState, int, float], None] | None = None,
                 save_every: int = 0, save_path: str | None = None) -> TrainLoopResult:
    """Sample, step, log, eval from ``state.step`` to the last step; export
    the best weights to ``<work_dir>/weights`` and call ``on_best(state, i,
    miou)``; a background full-state save to ``save_path`` at every
    ``i > 0`` divisible by ``save_every`` (0 = none)."""
    logger = MetricLogger(work_dir)
    steps = num_steps if num_steps is not None else cfg.train.num_steps
    it, loaders = make_train_iterator(cfg, wants_target(cfg))
    best_miou, best_step = 0.0, 0
    metrics: dict = {}
    evaluator = None
    t_last = time.time()
    try:
        for i in range(state.step, steps):
            batch = to_device(next(it), device)
            batch.pop("t_lbl", None)
            metrics = step_fn(state, batch)
            if save_every and save_path and i > 0 and i % save_every == 0:
                save_train_state(save_path, state, background=True)
            if i % log_every == 0:
                host = {k: float(v) for k, v in metrics.items()}
                dt, t_last = time.time() - t_last, time.time()
                host["steps_per_sec"] = (log_every if i else 1) / max(dt, 1e-9)
                logger.log(i, host)
                logger.print(i, host)
            if eval_apply is not None and cfg.train.eval_every > 0 and i > 0 \
                    and i % cfg.train.eval_every == 0:
                if evaluator is None:
                    evaluator = TwoScaleEvaluator(eval_apply, cfg.eval.num_classes,
                                                  cfg.eval.out_hw, cfg.eval.ds_hw, device)
                evaluator.score.reset()
                ds = cityscapes_dataset(cfg.data.target_root, cfg.data.val_img_list,
                                        cfg.data.val_lbl_list, split="val",
                                        resize_hw=cfg.eval.out_hw)
                for vb in iter_val(ds, eval_limit):
                    evaluator.update(vb["image"], vb["label"])
                miou = float(evaluator.score.get_scores()[0]["mean_iou"])
                logger.log(i, {"miou": miou}, prefix="val/")
                print(f"step {i}: val mIoU {miou:.4f}", flush=True)
                if miou > best_miou:
                    best_miou, best_step = miou, i
                    export_state_role_keyed(state, os.path.join(work_dir, "weights"))
                    print(f"saved best weights at step {i} (mIoU {miou:.4f})", flush=True)
                    if on_best is not None:
                        on_best(state, i, miou)
    finally:
        for ld in loaders:
            ld.stop()
        logger.close()
        wait_for_checkpoints()
    return TrainLoopResult(best_miou, best_step, {k: float(v) for k, v in metrics.items()})
