"""The training loop: loaders -> device prefetch -> step -> log -> eval.

Counterpart of ``diga_tpu/train/loop.py`` (:40-312) on one device:
  * the dual-scale multi-stream batches (the reference's small + full
    loader pairs, train_DiGA_gta2city_warm_up.py:117-136), built by host
    threads and copied to the device two batches ahead of the step
    (``data/prefetch.py::device_prefetch``, JAX :240);
  * the loop starts at ``state.step``, so a restored state resumes where
    it stopped (``diga_tpu/train/loop.py:248``);
  * in-loop two-scale eval every ``eval_every`` steps through
    ``TwoScaleEvaluator``, calling the caller's ``on_best`` on each new
    best mIoU (the CLI's ``on_best`` writes ``<work_dir>/weights`` and
    ``ckpt_best``, ``diga_tpu/cli/train_seg.py:95-105``; reference
    :343-373): a run with no eval, or none above mIoU 0, never calls it;
  * a full-state checkpoint to ``save_path`` every ``save_every`` steps,
    written in the background and joined at the end (``:274-276,306-309``);
  * ``profile_steps=(start, stop)``: a ``torch.profiler`` trace of those
    steps, CPU and CUDA, in ``<work_dir>/profile``; ``viz_every``: the
    train-view grids in ``<work_dir>/views`` (``:199-205,250-263``); the
    loss and mIoU curve PNGs beside ``metrics.jsonl`` at the end (:310).
The caller writes the final state (``ckpt_final``).  The translator
stage's two-stream iterator is ``make_translator_iterator``.

Under a process group (``parallel/dist.py``) every rank runs the loop on
its share of each batch; the in-loop eval is batch-sharded (rank r scores
its images of every eval batch of world size, the confusion matrix summed
over the ranks); only the writer, rank 0, writes: ``metrics.jsonl`` and
the log lines, ``on_best``, the ``save_every`` saves, the trace, the views
and the curves.
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
from ..data.prefetch import device_prefetch
from ..eval.evaluator import TwoScaleEvaluator, iter_val
from ..parallel import dist
from ..utils.checkpoint import save_train_state, wait_for_checkpoints
from ..utils.logging import MetricLogger
from ..utils.visualize import dump_train_views
from .build import wants_target
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
    (reference warm_up.py:208-230; both are cropped to the same size).
    Each stream is host-sharded: this host's rows of every global batch
    (``data/loader.py``)."""

    def __init__(self, datasets_and_batches, seed: int, num_workers: int, host_id: int = 0,
                 host_count: int = 1):
        self.loaders = [BatchLoader(ds, batch_size=b, seed=seed + 17 * i,
                                    num_workers=num_workers, host_id=host_id,
                                    host_count=host_count)
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
    numpy batches, the loaders to stop).  Every stream carries the recipe
    batch on each rank, host-sharded by the rank and the world of the
    process group (one host without one), so the global batch is the
    recipe times the world (``diga_tpu/train/loop.py:117-127``)."""
    crop = cfg.train.crop_hw
    hosts = dict(host_id=dist.rank(), host_count=dist.world())
    src = MultiStreamLoader([(build_dataset(s, cfg.data, crop, True), s.batch)
                             for s in cfg.data.source_streams],
                            seed=cfg.train.seed, num_workers=cfg.data.num_workers, **hosts)
    loaders = [src]
    tgt = None
    if with_target:
        tgt = MultiStreamLoader([(build_dataset(s, cfg.data, crop, False), s.batch)
                                 for s in cfg.data.target_streams],
                                seed=cfg.train.seed + 1000, num_workers=cfg.data.num_workers,
                                **hosts)
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
    stop): the translator's source and target streams, seeded and
    host-sharded as the seg stages' (``diga_tpu/cli/train_domain_translator.py:125-146``)."""
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


def _start_profile(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, device: torch.device, out_dir: str) -> None:
    """Stop the trace and write it (``trace.json``, for Perfetto or
    chrome://tracing) with its op table (``ops.txt``) into ``out_dir``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    sort = "self_cuda_time_total" if device.type == "cuda" else "self_cpu_time_total"
    with open(os.path.join(out_dir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=80))
    print(f"profile trace in {out_dir}", flush=True)


def run_training(cfg: ExperimentConfig, state: SegTrainState, step_fn: Callable,
                 eval_apply: Callable | None, work_dir: str, device: torch.device,
                 num_steps: int | None = None, eval_limit: int | None = None,
                 log_every: int = 50,
                 on_best: Callable[[SegTrainState, int, float], None] | None = None,
                 save_every: int = 0, save_path: str | None = None,
                 profile_steps: tuple[int, int] | None = None,
                 viz_every: int = 0) -> TrainLoopResult:
    """Sample, step, log, eval from ``state.step`` to the last step; call
    ``on_best(state, i, miou)`` on each new best mIoU; a background
    full-state save to ``save_path`` at every ``i > 0`` divisible by
    ``save_every`` (0 = none); a profiler trace of steps ``profile_steps``
    (both included) and train-view grids every ``viz_every`` steps.  Under
    a process group every rank calls it; only rank 0 writes."""
    writer = dist.is_writer()
    logger = MetricLogger(work_dir) if writer else None
    steps = num_steps if num_steps is not None else cfg.train.num_steps
    host_it, loaders = make_train_iterator(cfg, wants_target(cfg))
    it = device_prefetch(host_it, device, buffer_size=2)
    best_miou, best_step = 0.0, 0
    metrics: dict = {}
    evaluator = None
    prof = None
    t_last = time.time()
    try:
        for i in range(state.step, steps):
            if writer and profile_steps and i == profile_steps[0]:
                prof = _start_profile(device)
            batch = next(it)
            batch.pop("t_lbl", None)
            metrics = step_fn(state, batch)
            if prof is not None and i == profile_steps[1]:
                _stop_profile(prof, device, os.path.join(work_dir, "profile"))
                prof = None
            if writer and viz_every and i % viz_every == 0:
                dump_train_views(os.path.join(work_dir, "views"), i,
                                 {"source": batch["s_img"][:2].cpu().numpy()},
                                 {"label": batch["s_lbl"][:2].cpu().numpy()})
            if writer and save_every and save_path and i > 0 and i % save_every == 0:
                save_train_state(save_path, state, background=True)
            if writer and i % log_every == 0:
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
                for vb in iter_val(ds, eval_limit, rank=dist.rank(), world=dist.world()):
                    evaluator.update(vb["image"], vb["label"])
                miou = float(evaluator.score.get_scores()[0]["mean_iou"])
                if writer:
                    logger.log(i, {"miou": miou}, prefix="val/")
                    print(f"step {i}: val mIoU {miou:.4f}", flush=True)
                if miou > best_miou:
                    best_miou, best_step = miou, i
                    if on_best is not None and writer:
                        on_best(state, i, miou)
        if prof is not None:  # the run ended inside the profiled window
            _stop_profile(prof, device, os.path.join(work_dir, "profile"))
            prof = None
        if writer:
            logger.plot()
    finally:
        if prof is not None:
            prof.stop()
        for ld in loaders:
            ld.stop()
        if writer:
            logger.close()
        wait_for_checkpoints()
    return TrainLoopResult(best_miou, best_step, {k: float(v) for k, v in metrics.items()})
