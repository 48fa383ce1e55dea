"""Rank bodies and shared pieces of the data-parallel tests.

Imported by tests/test_torch_port_parallel*.py and by the spawned ranks
(``diga_tpu_torch.parallel.dist.launch``), which unpickle these functions
by name; it imports torch, never jax.  Run as a script it is one rank of a
torchrun-style world for the ``--multihost`` CLI test:

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=... MASTER_PORT=... \\
        python tests/_torch_port_parallel_sub.py cli OUT.json ARGV...

(registers the tiny DG preset with an eval after every step, runs
``train_dg.main(ARGV)`` and writes rank 0's last metrics to OUT.json).

A state is compared through ``digest``: every tensor of at most
``DIGEST_FULL`` elements whole, and of a larger one ``DIGEST_SAMPLE``
elements at indices drawn from a seed fixed by its name and shape (the
same on both sides of a comparison).  The tiny DeepLab's R101 widths make
a student, teacher and momentum about 370 MB a step; a fault in a
reduction (BN statistics, gradients, OHEM, the centroid scan) moves
nearly every element of the tensors downstream of it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import zlib

import numpy as np
import torch
import torch.nn as nn

from diga_tpu_torch.parallel import dist

LAYERS = (1, 1, 1, 1)
CROP = (32, 64)
DIGEST_FULL = 4096
DIGEST_SAMPLE = 4096
TINY_HRNET = {
    "stem_channels": 8, "stage1_blocks": 1, "stage1_channels": 8,
    "stages": [(1, 1, (8, 16)), (1, 1, (8, 16, 32)), (1, 1, (8, 16, 32, 64))],
    "ocr_mid_channels": 32, "ocr_key_channels": 16,
}
TRANSLATOR = {"enc": dict(dim=8, n_downsample=2, n_res=1),
              "dec": dict(dim=32, n_upsample=2, n_res=1)}


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def digest(sd: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """{prefix|name: the tensor whole, or its sampled elements} (module docstring)."""
    out = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        a = _np(v).astype(np.float64).reshape(-1)
        if a.size > DIGEST_FULL:
            seed = zlib.crc32(f"{k}{a.size}".encode())
            a = a[np.random.default_rng(seed).choice(a.size, DIGEST_SAMPLE, replace=False)]
        out[f"{prefix}|{k}"] = a
    return out


def rows(a, r: int, n: int):
    """Rank ``r``'s rows of a global array of ``n`` ranks."""
    b = a.shape[0] // n
    return a[r * b:(r + 1) * b]


def tiny_dg_preset(num_steps: int = 2, eval_every: int = 0):
    """The DG preset at tiny depth and size (layers (1, 1, 1, 1), crop
    32x64, f32, one image of each of the two source and target streams)."""
    from diga_tpu_torch.configs import presets

    base = presets.get_preset("dg_gta5")
    return dataclasses.replace(
        base,
        data=dataclasses.replace(
            base.data, num_workers=1,
            source_streams=(presets.LoaderSpec("gta5", (40, 72), 1),
                            presets.LoaderSpec("gta5", (48, 80), 1)),
            target_streams=(presets.LoaderSpec("cityscapes", (40, 72), 1),
                            presets.LoaderSpec("cityscapes", (48, 80), 1))),
        train=dataclasses.replace(base.train, crop_hw=CROP, compute_dtype="float32",
                                  num_steps=num_steps, eval_every=eval_every),
        eval=presets.EvalConfig(out_hw=(40, 72), ds_hw=(20, 36)),
        extra={"layers": LAYERS})


# ---------------------------------------------------------------------------
# step families
# ---------------------------------------------------------------------------

def translator_modules() -> nn.ModuleDict:
    """The six translator roles at tiny widths, drawn from a seed; each
    pair starts equal, as the translator CLI makes them."""
    import copy

    from diga_tpu_torch.models.translator import Discriminator, ImgDecoder, ImgEncoder
    from diga_tpu_torch.train.build import seeded

    with seeded(5):
        enc, dec = ImgEncoder(**TRANSLATOR["enc"]), ImgDecoder(**TRANSLATOR["dec"],
                                                              subpixel_up=True)
        dis = Discriminator(dim=8, n_layer=2, num_scales=2)
    return nn.ModuleDict({"enc_s": enc, "enc_t": copy.deepcopy(enc), "dec_s2t": dec,
                          "dec_t2s": copy.deepcopy(dec), "dis_s2t": dis,
                          "dis_t2s": copy.deepcopy(dis)})


def build_family(spec: dict):
    """(state, step) of one family from ``spec``; under a process group its
    BNs are synced and its modules broadcast, as ``build_experiment`` does."""
    from diga_tpu_torch.models.hrnet_ocr import HRNetOCR
    from diga_tpu_torch.models.resnet_deeplab import DeepLabV2
    from diga_tpu_torch.models.translator import ImgDecoder, ImgEncoder
    from diga_tpu_torch.ops.prototypes import Centroids
    from diga_tpu_torch.parallel.sync_bn import convert_sync_bn
    from diga_tpu_torch.train.build import seeded
    from diga_tpu_torch.train.optim import sgd_grouped
    from diga_tpu_torch.train.schedules import poly_schedule, poly_warmup_schedule
    from diga_tpu_torch.train.state import create_seg_state
    from diga_tpu_torch.train.steps import (StepConfig, build_dg_step, build_selftrain_step,
                                            build_warmup_step)
    from diga_tpu_torch.train.steps_translator import (TranslatorConfig, build_translator_step,
                                                       create_translator_state)

    init = spec.get("init")
    if isinstance(init, str):
        init = dict(np.load(init))
    load = lambda m, part: m.load_state_dict(
        {k.split("|", 1)[1]: torch.from_numpy(np.asarray(v)) for k, v in init.items()
         if k.startswith(part + "|")}, strict=True)
    if spec["kind"] == "translator":
        mods = translator_modules()
        dist.broadcast_module(mods)
        state = create_translator_state(mods, 1e-4)
        return state, build_translator_step(TranslatorConfig(compute_dtype=torch.float32),
                                            poly_schedule(1e-4, spec["max_iter"]))
    k = spec["K"]
    with seeded(spec.get("seed", 0)):
        if spec["kind"] == "hrnet":
            student = HRNetOCR(num_classes=k, arch=TINY_HRNET, droprate=spec["droprate"])
        else:
            student = DeepLabV2(num_classes=k, layers=LAYERS, droprate=spec["droprate"])
        enc, dec = ImgEncoder(**TRANSLATOR["enc"]), ImgDecoder(**TRANSLATOR["dec"])
    if init is not None:
        load(student, "student")
    elif spec.get("bn_bias") is not None:
        # the frozen BN biases, and the ASPP branches' GroupNorm biases, at
        # +4 keep every ReLU input of the backbone and the head off its
        # kink, as in the parity recipes (tests/_torch_port_steps.py,
        # tests/_torch_port_selftrain_ref.py)
        with torch.no_grad():
            for m in student.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.bias.fill_(spec["bn_bias"])
            for branch in student.final.conv2d_list:
                branch[1].bias.fill_(spec["bn_bias"])
    convert_sync_bn(student)
    dist.broadcast_module(student)
    translator = None
    if spec["stage"] == "warmup" or (spec["stage"] == "selftrain"
                                     and spec["opts"].get("use_crdomix", True)):
        if init is not None:
            load(enc, "enc_s")
            load(dec, "dec_s2t")
        translator = nn.ModuleDict({"enc_s": enc, "dec_s2t": dec})
        dist.broadcast_module(translator)
    centroids = None
    if spec["stage"] == "selftrain":
        if init is not None:
            centroids = Centroids(torch.from_numpy(np.asarray(init["centroids|vectors"])),
                                  torch.from_numpy(np.asarray(init["centroids|counts"])))
        else:
            g = torch.Generator().manual_seed(11)
            centroids = Centroids(torch.randn((k, spec["feat_dim"]), generator=g) * 0.1,
                                  torch.full((k,), 150.0))
    opt = sgd_grouped(student, spec["lr"], momentum=0.9, weight_decay=5e-4,
                      head_mult=spec.get("head_mult", 10.0))
    state = create_seg_state(student, opt, seed=0, translator=translator, centroids=centroids)
    if init is not None:
        load(state.teacher, "teacher")
    cfg = StepConfig(num_classes=k, crop_hw=CROP, compute_dtype=torch.float32, **spec["opts"])
    sched = (poly_warmup_schedule(spec["lr"], 1000, spec["lr_warmup"], 0.9)
             if spec.get("lr_warmup") else poly_schedule(spec["lr"], 1000, spec.get("power", 0.9)))
    build = {"dg": build_dg_step, "warmup": build_warmup_step,
             "selftrain": build_selftrain_step}[spec["stage"]]
    return state, build(cfg, sched)


def _injected(inject: dict | None, r: int, n: int) -> dict:
    """The step's injected draws, this rank's rows (kornia's order is shared)."""
    out = {}
    for name, v in (inject or {}).items():
        if isinstance(v, dict):
            out[name] = {k: torch.from_numpy(np.asarray(a) if k == "order"
                                             else rows(np.asarray(a), r, n))
                         for k, a in v.items()}
        else:
            out[name] = torch.from_numpy(rows(np.asarray(v), r, n))
    return out


def snapshot(spec: dict, state, metrics: dict) -> dict:
    """The step's metrics and the digests of everything the step moves."""
    snap = {"metrics": {k: float(v) for k, v in metrics.items()}}
    if spec["kind"] == "translator":
        for role, m in state.modules.items():
            snap.update(digest(m.state_dict(), role))
        return snap
    snap.update(digest(state.student.state_dict(), "student"))
    snap.update(digest(state.teacher.state_dict(), "teacher"))
    mu = {k: state.optimizer.state[p]["momentum_buffer"]
          for k, p in state.student.named_parameters()
          if p.requires_grad and p in state.optimizer.state}
    snap.update(digest(mu, "mu"))
    if state.centroids is not None:
        snap["centroids|vectors"] = _np(state.centroids.vectors).astype(np.float64).reshape(-1)
        snap["centroids|counts"] = _np(state.centroids.counts).astype(np.float64)
    return snap


def _params(state) -> list[torch.Tensor]:
    if hasattr(state, "modules") and isinstance(state.modules, nn.ModuleDict):
        return list(state.modules.parameters())
    return list(state.student.parameters()) + list(state.teacher.parameters())


def run_family(spec: dict) -> dict:
    """``spec``'s steps on this process's share of each global batch (all of
    it without a group); the initial state's and each step's snapshots, and
    whether the parameters are equal on every rank after the last step."""
    r, n = dist.rank(), dist.world()
    state, step = build_family(spec)
    snaps = [snapshot(spec, state, {})]  # the initial state
    for i, batch in enumerate(spec["batches"]):
        local = {k: torch.from_numpy(rows(np.asarray(v), r, n)) for k, v in batch.items()}
        inject = _injected(spec["inject"][i] if spec.get("inject") else None, r, n)
        snaps.append(snapshot(spec, state, step(state, local, **inject)))
    flat = torch.cat([p.detach().reshape(-1) for p in _params(state)])
    every = dist.gather_rows(flat[None])
    return {"steps": snaps, "equal_on_every_rank": bool((every == every[:1]).all())}


def run_families(specs: dict) -> dict:
    import gc

    out = {}
    for name, spec in specs.items():
        out[name] = run_family(spec)
        gc.collect()
    return out


# ---------------------------------------------------------------------------
# the units: SyncBatchNorm2d, loaders, OHEM, the centroid scan, eval, draws
# ---------------------------------------------------------------------------

def units(data: dict) -> list[dict]:
    """Every rank's results (gathered to each rank) of the unit checks on
    its share of the global inputs in ``data``."""
    import torch.distributed as tdist

    from diga_tpu_torch.ops.losses import ohem_cross_entropy
    from diga_tpu_torch.ops.prototypes import Centroids, update_centroids
    from diga_tpu_torch.parallel.sync_bn import SyncBatchNorm2d, convert_sync_bn

    r, n = dist.rank(), dist.world()
    out: dict = {"rank": r, "world": n, "backend": dist.backend()}

    # SyncBatchNorm2d through convert_sync_bn, trainable affine
    bn = nn.BatchNorm2d(data["bn_x"].shape[1])
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in data["bn_state"].items()})
    model = convert_sync_bn(nn.Sequential(bn))
    out["bn_class"] = type(model[0]).__name__
    out["bn_is_sync"] = isinstance(model[0], SyncBatchNorm2d)
    x = torch.from_numpy(rows(data["bn_x"], r, n)).to(memory_format=torch.channels_last)
    x.requires_grad_(True)
    y = model(x)
    (y * torch.from_numpy(rows(data["bn_g"], r, n))).sum().backward()
    out["bn_y"] = _np(y)
    out["bn_dx"] = _np(x.grad)
    out["bn_dw"] = _np(dist.all_reduce_sum(model[0].weight.grad))
    out["bn_db"] = _np(dist.all_reduce_sum(model[0].bias.grad))
    out["bn_running"] = {k: _np(v) for k, v in model[0].state_dict().items()}
    model.eval()
    out["bn_eval_y"] = _np(model(x.detach()))

    # OHEM over the global batch: the value and d(global loss)/d(local logits)
    logits = torch.from_numpy(rows(data["ohem_logits"], r, n)).requires_grad_(True)
    loss = ohem_cross_entropy(logits, torch.from_numpy(rows(data["ohem_labels"], r, n)),
                              thresh=data["ohem_thresh"], min_kept=data["ohem_min_kept"])
    (loss / n).backward()  # the global loss is the ranks' average
    out["ohem_loss"] = float(dist.all_reduce_sum(loss.detach()) / n)
    out["ohem_grad"] = _np(logits.grad)

    # the centroid scan over every rank's rows in global order
    cents = Centroids(torch.from_numpy(data["cent_vectors"]), torch.from_numpy(data["cent_counts"]))
    vec = torch.from_numpy(rows(data["cent_batch"], r, n))
    ok = torch.from_numpy(rows(data["cent_ok"], r, n))
    new = update_centroids(cents, dist.gather_rows(vec), dist.gather_rows(ok), start_mean=True)
    out["cent_vectors"], out["cent_counts"] = _np(new.vectors), _np(new.counts)

    # the rows of a world-n draw, and a gradient all-reduce, and a broadcast
    out["rows_one"] = dist.local_rows(2)
    out["rows_parts"] = dist.local_rows(5, (2, 3))
    out["drawn"] = _np(dist.draw_local(lambda m: torch.arange(m * 3.0).reshape(m, 3), 2))
    lin = nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(float(r + 1))
        lin.bias.fill_(float(10 * (r + 1)))
    dist.broadcast_module(lin)
    out["broadcast"] = _np(lin.weight), _np(lin.bias)
    lin.weight.grad = torch.full_like(lin.weight, float(r + 1))
    dist.all_reduce_grads(lin.parameters())  # the bias has no gradient: left alone
    out["grad_mean"] = _np(lin.weight.grad)
    out["bias_grad"] = lin.bias.grad

    # loaders: this rank's rows of the first two global batches
    if data.get("loader") is not None:
        from diga_tpu_torch.data.loader import BatchLoader

        ld = data["loader"]
        loader = BatchLoader(loader_dataset(ld), batch_size=ld["batch"], seed=ld["seed"],
                             num_workers=2, host_id=r, host_count=n)
        it = iter(loader)
        out["loader"] = [next(it) for _ in range(2)]
        loader.stop()
        from diga_tpu_torch.train.loop import make_train_iterator

        host_it, loaders = make_train_iterator(data["train_cfg"], with_target=True)
        out["train_batch"] = next(host_it)
        for x_ in loaders:
            x_.stop()

    # batch-sharded eval with a padded tail
    if data.get("eval") is not None:
        out["eval"] = sharded_eval(data["eval"])

    every = [None] * n
    tdist.all_gather_object(every, out)
    return every


def loader_dataset(ld: dict):
    """The GTA5 fixture with the source stream's flip and random crop."""
    from diga_tpu_torch.data import Compose, RandomCrop, RandomHorizontallyFlip, gta5_dataset

    return gta5_dataset(ld["root"], ld["list"], resize_hw=ld["hw"],
                        transform=Compose([RandomHorizontallyFlip(), RandomCrop(list(ld["crop"]))]))


def eval_model():
    """The tiny DeepLab's eval apply, drawn from a seed."""
    from diga_tpu_torch.models.resnet_deeplab import DeepLabV2
    from diga_tpu_torch.train.build import _eval_apply, seeded

    with seeded(3):
        model = DeepLabV2(num_classes=19, layers=LAYERS)
    return _eval_apply(model.eval(), False, None)


def sharded_eval(spec: dict) -> dict:
    """The confusion matrix and scores of ``TwoScaleEvaluator`` over the val
    fixture, this rank's images of every eval batch (all of them without a
    group), and the names it scored."""
    from diga_tpu_torch.data import cityscapes_dataset
    from diga_tpu_torch.eval.evaluator import TwoScaleEvaluator, iter_val

    ds = cityscapes_dataset(spec["root"], spec["img_list"], spec["lbl_list"], split="val",
                            resize_hw=spec["hw"])
    ev = TwoScaleEvaluator(eval_model(), 19, spec["hw"], spec["ds_hw"], torch.device("cpu"))
    names = []
    for vb in iter_val(ds, None, batch=spec["batch"], rank=dist.rank(), world=dist.world()):
        ev.update(vb["image"], vb["label"])
        names += vb["names"]
        assert len(vb["names"]) == vb["valid"]
    scores = ev.score.get_scores()[0]
    return {"scores": {k: float(v) for k, v in scores.items()}, "names": names,
            "confusion": _np(dist.all_reduce_sum(ev.score.confusion))}


def dead_rank() -> None:
    """Rank 1 dies at once; rank 0 waits in an all-reduce for it."""
    if dist.rank() == 1:
        os._exit(3)
    dist.all_reduce_sum(torch.ones(4))


def _cli(out_path: str, argv: list[str]) -> None:
    from diga_tpu_torch.cli import train_dg
    from diga_tpu_torch.configs import presets

    torch.set_num_threads(1)
    presets.PRESETS["tiny_dg"] = tiny_dg_preset(eval_every=1)
    result = train_dg.main(argv)
    if int(os.environ["RANK"]) == 0:
        with open(out_path, "w") as f:
            json.dump(result.last_metrics, f)


if __name__ == "__main__":
    if sys.argv[1] != "cli":
        raise SystemExit(f"unknown mode {sys.argv[1]!r}")
    _cli(sys.argv[2], sys.argv[3:])
