"""Long-horizon convergence soak.

Counterpart of ``diga_tpu/cli/soak.py`` on one device (``--device``,
default ``cuda``).  Three modes:

  fixtures (default) — training on synthetic image fixtures through the
      real harness (loaders -> step -> periodic eval -> checkpoints),
      asserting (a) the trailing-window loss mean below the leading
      window's, (b) the best val mIoU at least the first, and (c) a
      mid-run checkpoint restored into a freshly built experiment resumes
      at its step.  Production widths by default; ``--tiny`` shrinks the
      model and the crop for the CPU.
  translator — the same for a translator preset: every loss finite, the
      self-reconstruction L1 falling, D's loss below 4.0, and a mid-run
      role-keyed export read back into the six modules (strict, equal)
      before the run goes on.
  onchip — batches generated on the device (a ``torch.Generator`` on it,
      seeded per step) with labels banded from the image
      (``banded_labels``), so the task is learnable with no data;
      production scale; asserts a finite, falling loss (the translator
      presets: the translator invariants) and prints the sustained imgs/s.

Artifacts: ``<work_dir>/metrics.jsonl`` with the loss and mIoU curves
(fixtures), ``metrics.jsonl`` (translator), ``soak_onchip*.jsonl`` (onchip).

Usage:
  python -m diga_tpu_torch.cli.soak --preset gta2city_warmup --steps 2000 \\
      --work_dir work/soak [--tiny] [--mode onchip] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..utils.checkpoint import load_role_keyed
from .common import base_parser, get_config, refuse_multi_device


def main(argv=None):
    p = base_parser("DiGA convergence soak (PyTorch/CUDA port)")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--mode", choices=["fixtures", "onchip"], default="fixtures")
    p.add_argument("--tiny", action="store_true",
                   help="tiny model + crop (the CPU-runnable configuration)")
    p.add_argument("--resume_at", type=int, default=None,
                   help="simulate a failure: checkpoint, rebuild and resume at this step "
                        "(default: steps // 2)")
    args = p.parse_args(argv)
    refuse_multi_device(p, args)
    if args.mode == "onchip":
        return soak_onchip(args)
    if get_config(args).stage == "translator":
        return soak_translator(args)
    return soak_fixtures(args)


def _fixture_streams(cfg, work: str, tiny: bool, with_val: bool):
    """Generate the fixtures under ``<work>/data`` and point ``cfg`` at
    them, every stream resized to the fixture size; returns (cfg, (fh, fw))."""
    from ..data import synthetic

    fh, fw = (48, 96) if tiny else (96, 160)
    root = os.path.join(work, "data")
    gta, city = os.path.join(root, "gta"), os.path.join(root, "city")
    gta_list = synthetic.make_gta5_fixture(gta, n=8, h=fh, w=fw)
    img_list, lbl_list = synthetic.make_cityscapes_fixture(city, n=6, h=fh, w=fw, split="train")
    paths = dict(source_root=gta, target_root=city, source_list=gta_list,
                 target_img_list=img_list, target_lbl_list=lbl_list)
    if with_val:
        paths["val_img_list"], paths["val_lbl_list"] = synthetic.make_cityscapes_fixture(
            city, n=4, h=fh, w=fw, split="val")
        # the self-training presets also read pseudo-labels (reference-format
        # palette PNGs): the consensus and centroid path runs on fixtures
        if cfg.stage == "selftrain":
            paths["pseudo_dir"] = synthetic.make_pseudo_fixture(city, img_list, fh, fw)
    resized = lambda streams: tuple(dataclasses.replace(s, resize_hw=(fh, fw))  # noqa: E731
                                    for s in streams)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, **paths, source_streams=resized(cfg.data.source_streams),
        target_streams=resized(cfg.data.target_streams)))
    return cfg, (fh, fw)


def soak_fixtures(args):
    from ..train.build import build_experiment
    from ..train.loop import run_training
    from ..utils.checkpoint import restore_train_state, save_train_state

    device = resolve_device(args.device)
    cfg = get_config(args)
    work = args.work_dir
    os.makedirs(work, exist_ok=True)
    if not (cfg.data.source_list and os.path.exists(cfg.data.source_list)):
        cfg, (fh, fw) = _fixture_streams(cfg, work, args.tiny, with_val=True)
        cfg = dataclasses.replace(cfg, eval=dataclasses.replace(
            cfg.eval, out_hw=(fh, fw), ds_hw=(fh // 2, fw // 2)))
        if args.tiny:  # the JAX tool also sets remat=False, a knob the port has not
            cfg = dataclasses.replace(
                cfg, train=dataclasses.replace(cfg.train, crop_hw=(32, 64),
                                               compute_dtype="float32"),
                extra={**cfg.extra, "layers": (1, 1, 1, 1)})
        else:
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                     crop_hw=(64, 128)))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_steps=args.steps, eval_every=max(args.steps // 4, 1)))

    resume_at = args.resume_at if args.resume_at is not None else args.steps // 2
    ckpt = os.path.join(work, "ckpt_soak")
    # the head/tail assertion needs about 10 samples after the resume alone
    log_every = max(1, (args.steps - resume_at) // 20)

    # ---- phase 1: run to resume_at, checkpoint, throw the state away ----
    state, step, eval_apply = build_experiment(cfg, device)
    result1 = run_training(cfg, state, step, eval_apply, os.path.join(work, "phase1"), device,
                           num_steps=resume_at, eval_limit=4, log_every=log_every)
    save_train_state(ckpt, state)
    mid_loss = result1.last_metrics["loss"]
    del state, step, eval_apply

    # ---- phase 2: a freshly built experiment, restored, run to the end ----
    state, step, eval_apply = build_experiment(cfg, device)
    restore_train_state(ckpt, state)
    _check(state.step == resume_at, (state.step, resume_at))
    result2 = run_training(cfg, state, step, eval_apply, work, device, num_steps=args.steps,
                           eval_limit=4, log_every=log_every)

    # ---- assertions over the recorded trajectory ----
    head, tail = _loss_windows(os.path.join(work, "metrics.jsonl"))
    print(f"soak: loss window means head={head:.4f} tail={tail:.4f} "
          f"(mid-run resume at {resume_at}: loss {mid_loss:.4f})")
    _check(np.isfinite(tail), "non-finite trailing loss")
    _check(tail < head, f"loss did not decrease: head {head:.4f} -> tail {tail:.4f}")
    mious = _series(os.path.join(work, "metrics.jsonl"), "val/miou")
    m0, m1 = mious[0], result2.best_miou
    print(f"soak: mIoU first={m0:.4f} best={m1:.4f}")
    _check(m1 >= m0, f"val mIoU degraded: {m0:.4f} -> {m1:.4f}")
    print(f"soak ok: {args.steps} steps, curves (loss.png, val_miou.png) in {work}")
    return {"head": head, "tail": tail, "first_miou": m0, "best_miou": m1}


def soak_translator(args):
    """The translator stage on fixtures through the CLI's own
    ``build_translator_experiment``:
    (a) every D/G loss finite, (b) the self-reconstruction L1 falling (the
    GAN's non-adversarial anchor: the adversarial terms oscillate by
    design), (c) D's loss below 4.0, and (d) a mid-run role-keyed export
    read back into the six modules and continued.  Reference budget: 50k
    steps (train_domain_translator.py:78-83)."""
    from ..train.loop import make_translator_iterator, to_device
    from .train_domain_translator import build_translator_experiment, export_translator

    device = resolve_device(args.device)
    cfg = get_config(args)
    work = args.work_dir
    os.makedirs(work, exist_ok=True)
    if not (cfg.data.source_list and os.path.exists(cfg.data.source_list)):
        cfg, _ = _fixture_streams(cfg, work, args.tiny, with_val=False)
        if args.tiny:
            cfg = dataclasses.replace(
                cfg, train=dataclasses.replace(cfg.train, crop_hw=(32, 64),
                                               compute_dtype="float32"),
                extra={**cfg.extra, "enc_dim": 8, "dec_dim": 32, "n_res": 1,
                       "dis_dim": 8, "dis_layers": 2, "dis_scales": 2})
        else:
            cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                     crop_hw=(64, 128)))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, num_steps=args.steps))
    state, step = build_translator_experiment(cfg, device)
    it, loaders = make_translator_iterator(cfg)

    resume_at = args.resume_at if args.resume_at is not None else args.steps // 2
    weight_dir = os.path.join(work, "weights_mid")
    log_path = os.path.join(work, "metrics.jsonl")
    self_losses, d_losses, g_losses = [], [], []
    try:
        with open(log_path, "w") as log:
            for i in range(args.steps):
                rec = {k: float(v) for k, v in step(state, to_device(next(it), device)).items()}
                for v in rec.values():
                    _check(np.isfinite(v), f"non-finite metric at step {i}: {rec}")
                self_losses.append(rec["loss_self"])
                d_losses.append(max(rec["loss_d_s2t"], rec["loss_d_t2s"]))
                g_losses.append(rec["loss_g"])
                if i % 25 == 0:
                    log.write(json.dumps({"step": i, **rec}) + "\n")
                    log.flush()
                if i == resume_at:
                    # mid-run role-keyed export -> reload -> continue: the
                    # stage-chaining path the warm-up reads (enc_s/dec_s2t)
                    export_translator(state, weight_dir)
                    reload_translator(state, weight_dir)
    finally:
        for ld in loaders:
            ld.stop()
    head, tail = _head_tail(self_losses)
    d_max = float(np.max(d_losses))
    print(f"translator soak: self-recon L1 head={head:.4f} tail={tail:.4f}, "
          f"max D loss={d_max:.4f}, final G loss={g_losses[-1]:.4f}")
    _check(tail < head, f"self-recon did not improve: {head:.4f} -> {tail:.4f}")
    # LSGAN D loss is bounded near init (real/fake scored ~0 -> loss ~1); a
    # diverged D saturates toward (1-(-big))^2: 4.0 is far above any healthy run
    _check(d_max < 4.0, f"D loss diverged: {d_max}")
    print(f"translator soak ok: {args.steps} steps "
          f"(export/reload/continue at {resume_at}); metrics in {log_path}")
    return {"head": head, "tail": tail, "d_max": d_max}


def reload_translator(state, weight_dir: str) -> None:
    """Read the six role-keyed ``.pth`` files back into ``state``'s modules
    (strict), after requiring each equal to the module's weights; the Adam
    states stay (the reference's reload path also restores weights only)."""
    from ..train.steps_translator import ROLES

    sds = load_role_keyed(weight_dir, list(ROLES))
    for role in ROLES:
        module = state.modules[role]
        for k, v in module.state_dict().items():
            _check(torch.equal(v.cpu(), sds[role][k]), f"{role}.{k} changed in the round trip")
        module.load_state_dict(sds[role], strict=True)


def _check(cond: bool, msg) -> None:
    """The soak's invariant: an AssertionError with ``msg`` where it fails
    (raised, not asserted, so that ``python -O`` keeps it)."""
    if not cond:
        raise AssertionError(msg)


def _series(metrics_path, key):
    vals = []
    with open(metrics_path) as f:
        for line in f:
            rec = json.loads(line)
            if key in rec:
                vals.append(rec[key])
    _check(vals, f"no '{key}' entries recorded in {metrics_path}")
    return vals


def _loss_windows(metrics_path, frac=0.2):
    return _head_tail(_series(metrics_path, "loss"), frac)


def _head_tail(values: list[float], frac: float = 0.2) -> tuple[float, float]:
    """Means of the first and last ``frac`` of ``values`` (at least one each)."""
    k = max(int(len(values) * frac), 1)
    return float(np.mean(values[:k])), float(np.mean(values[-k:]))


def banded_labels(img: torch.Tensor, num_classes: int) -> torch.Tensor:
    """The onchip soak's learnable labels: ``clip(int(mean_c(img)·8 +
    num_classes/2), 0, num_classes − 1)``, truncated toward zero, int32;
    the channel mean is a sum over 3 divided by 3, as ``jnp.mean``."""
    band = (img.sum(-1) / img.shape[-1] * 8 + num_classes / 2).to(torch.int32)
    return torch.clamp(band, 0, num_classes - 1)


def banded_pseudo_labels(t_img: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``banded_labels`` with ignore (255) where channel 0 exceeds 0.64, about
    10 % of the pixels, as real pseudo-label dumps have."""
    return torch.where(t_img[..., 0] > 0.64, 255, banded_labels(t_img, num_classes))


def _onchip_batches(cfg, device: torch.device, with_target: bool, selftrain: bool):
    """``make_batch(i)``: the step's batch drawn on ``device`` from a
    generator seeded with ``i``."""
    crop, ncls = cfg.train.crop_hw, cfg.train.num_classes
    bs = sum(s.batch for s in cfg.data.source_streams)
    bt = sum(s.batch for s in cfg.data.target_streams)

    def make_batch(i: int) -> dict:
        g = torch.Generator(device=device).manual_seed(i)
        img = 0.5 * torch.randn((bs, *crop, 3), generator=g, device=device)
        batch = {"s_img": img, "s_lbl": banded_labels(img, ncls)}
        if with_target:
            batch["t_img"] = 0.5 * torch.randn((bt, *crop, 3), generator=g, device=device)
        if selftrain:
            batch["t_pseudo"] = banded_pseudo_labels(batch["t_img"], ncls)
        return batch

    return make_batch, bs


def soak_onchip(args):
    from ..train.build import build_experiment, wants_target

    device = resolve_device(args.device)
    # the soak runs the same program as the CLIs: the preset's own configuration
    cfg = get_config(args)
    if cfg.stage == "translator":
        return _soak_onchip_translator(args, cfg, device)
    state, step, _ = build_experiment(cfg, device)
    make_batch, batch_n = _onchip_batches(cfg, device, wants_target(cfg),
                                          cfg.stage == "selftrain")
    os.makedirs(args.work_dir, exist_ok=True)
    first = last = float(step(state, make_batch(0))["loss"])
    print(f"step 0: loss={first:.4f}", flush=True)
    rate = 0.0
    t0 = time.perf_counter()
    with open(os.path.join(args.work_dir, "soak_onchip.jsonl"), "w") as log:
        for i in range(1, args.steps):
            m = step(state, make_batch(i))
            if i % 100 == 0 or i == args.steps - 1:
                last = float(m["loss"])
                _check(np.isfinite(last), f"non-finite loss at step {i}")
                rate = batch_n * i / (time.perf_counter() - t0)
                print(f"step {i}: loss={last:.4f} ({rate:.2f} imgs/s sustained)", flush=True)
                log.write(json.dumps({"step": i, "loss": last, "imgs_per_sec": rate}) + "\n")
    _check(last < first, f"loss did not decrease: {first:.4f} -> {last:.4f}")
    print(f"soak ok: {args.steps} steps, {first:.4f} -> {last:.4f}")
    return {"first": first, "last": last, "imgs_per_sec": rate}


def _soak_onchip_translator(args, cfg, device: torch.device):
    """The shipped translator step (fused, six Adams) on device-generated
    batches, with the fixture soak's health invariants."""
    from .train_domain_translator import build_translator_experiment

    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, num_steps=args.steps))
    state, step = build_translator_experiment(cfg, device)
    make_batch, batch_n = _onchip_batches(cfg, device, with_target=True, selftrain=False)
    os.makedirs(args.work_dir, exist_ok=True)
    self_losses, d_max, g_last, rate = [], 0.0, 0.0, 0.0
    t0 = time.perf_counter()
    with open(os.path.join(args.work_dir, "soak_onchip_translator.jsonl"), "w") as log:
        for i in range(args.steps):
            m = step(state, make_batch(i))
            if i % 25 == 0 or i == args.steps - 1:
                rec = {k: float(v) for k, v in m.items()}
                for v in rec.values():
                    _check(np.isfinite(v), f"non-finite metric at step {i}: {rec}")
                self_losses.append(rec["loss_self"])
                d_max = max(d_max, rec["loss_d_s2t"], rec["loss_d_t2s"])
                g_last = rec["loss_g"]
                rate = batch_n * (i + 1) / (time.perf_counter() - t0)
                log.write(json.dumps({"step": i, **rec, "imgs_per_sec": rate}) + "\n")
                log.flush()
                if i % 100 == 0:
                    print(f"step {i}: self={rec['loss_self']:.4f} g={rec['loss_g']:.4f} "
                          f"dmax={d_max:.4f} ({rate:.2f} imgs/s)", flush=True)
    head, tail = _head_tail(self_losses)
    _check(tail < head, f"self-recon did not improve: {head:.4f} -> {tail:.4f}")
    _check(d_max < 4.0, f"D loss diverged: {d_max}")
    print(f"translator onchip soak ok: {args.steps} steps, self-recon {head:.4f} -> "
          f"{tail:.4f}, max D {d_max:.4f}, final G {g_last:.4f} ({rate:.2f} imgs/s)")
    return {"head": head, "tail": tail, "d_max": d_max, "imgs_per_sec": rate}


if __name__ == "__main__":
    main()
