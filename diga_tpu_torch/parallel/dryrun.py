"""One step of every train family over a world of n processes.

The twin of ``__graft_entry__.py::dryrun_multichip`` (:79-256): at the same
tiny shapes (crop 32x64, 19 classes, DeepLabV2 at one bottleneck a stage,
translator encoders 8 / decoders 32 / 2-scale PatchGANs of 2 layers, an
HRNet+OCR of branches 8-64), one image per rank, it runs the translator
GAN step, the batch-sharded two-scale eval, the height-sharded two-scale
eval of one image (its rows over the ranks, ``parallel/spatial.py``; the
crop height must divide by the world), the self-training step, the
warm-up step (with the target-stats forward) and the semiseg HRNet+OCR
step (aux term, RGB input), each on every rank of the world, and requires
finite losses and parameters equal on every rank after each step.

    python -m diga_tpu_torch.parallel.dryrun N [--device cpu]

On ``cuda`` it computes in bf16 (the JAX dryrun's compute dtype) and runs
the port's kernels; on the CPU in f32 over gloo.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch
import torch.nn as nn

from . import dist
from .sync_bn import convert_sync_bn

CROP = (32, 64)
NUM_CLASSES = 19
TINY_HRNET = {
    "stem_channels": 8, "stage1_blocks": 1, "stage1_channels": 8,
    "stages": [(1, 1, (8, 16)), (1, 1, (8, 16, 32)), (1, 1, (8, 16, 32, 64))],
    "ocr_mid_channels": 32, "ocr_key_channels": 16,
}
FAMILIES = ("translator", "batch_eval", "spatial_eval", "selftrain", "warmup", "semiseg")


def _global_batch(n: int, seed: int = 0) -> dict[str, np.ndarray]:
    """One image per rank of every stream, drawn for the whole world."""
    rr = np.random.default_rng(seed)
    img = lambda: (rr.normal(size=(n, *CROP, 3)) * 0.5).astype(np.float32)
    lbl = lambda: rr.integers(0, NUM_CLASSES, size=(n, *CROP)).astype(np.int32)
    return {"s_img": img(), "s_lbl": lbl(), "t_img": img(), "t_pseudo": lbl(),
            "h_img": img(), "h_lbl": lbl()}


def _params_equal_on_every_rank(*modules: nn.Module) -> bool:
    flat = torch.cat([p.detach().reshape(-1).to(torch.float64)
                      for m in modules for p in m.parameters()])
    every = dist.gather_rows(flat[None])
    return bool((every == every[:1]).all())


def _check(name: str, loss: float, *modules: nn.Module) -> None:
    if not math.isfinite(loss):
        raise RuntimeError(f"dryrun_multichip: non-finite {name} loss {loss}")
    if not _params_equal_on_every_rank(*modules):
        raise RuntimeError(f"dryrun_multichip: {name} parameters differ between ranks")


def _seg_model(kind: str, device: torch.device) -> nn.Module:
    from ..models.hrnet_ocr import HRNetOCR
    from ..models.resnet_deeplab import DeepLabV2
    from ..train.build import seeded

    with seeded(0):
        model = (HRNetOCR(num_classes=NUM_CLASSES, arch=TINY_HRNET) if kind == "hrnet"
                 else DeepLabV2(num_classes=NUM_CLASSES, layers=(1, 1, 1, 1)))
    model = convert_sync_bn(model.to(device))
    dist.broadcast_module(model)
    return model


def _translator(device: torch.device) -> nn.ModuleDict:
    from ..models.translator import Discriminator, ImgDecoder, ImgEncoder
    from ..train.build import seeded

    with seeded(7):
        mods = nn.ModuleDict({
            "enc_s": ImgEncoder(dim=8, n_downsample=2, n_res=1),
            "enc_t": ImgEncoder(dim=8, n_downsample=2, n_res=1),
            "dec_s2t": ImgDecoder(dim=32, n_upsample=2, n_res=1, subpixel_up=True),
            "dec_t2s": ImgDecoder(dim=32, n_upsample=2, n_res=1, subpixel_up=True),
            "dis_s2t": Discriminator(dim=8, n_layer=2, num_scales=2),
            "dis_t2s": Discriminator(dim=8, n_layer=2, num_scales=2)}).to(device)
    dist.broadcast_module(mods)
    return mods


def run_rank(device_type: str) -> dict[str, float]:
    """Every family's one step on this rank; {family: loss or mIoU}."""
    device = dist.local_device(device_type)
    # timing every conv of five tiny models once costs more than their one step
    benchmark, torch.backends.cudnn.benchmark = torch.backends.cudnn.benchmark, False
    try:
        return _run_families(device)
    finally:
        torch.backends.cudnn.benchmark = benchmark


def _run_families(device: torch.device) -> dict[str, float]:
    from ..eval.evaluator import TwoScaleEvaluator
    from ..ops.prototypes import Centroids
    from ..train.build import _eval_apply
    from ..train.optim import sgd_grouped
    from ..train.schedules import poly_schedule
    from ..train.state import create_seg_state
    from ..train.steps import StepConfig, build_dg_step, build_selftrain_step, build_warmup_step
    from ..train.steps_translator import (TranslatorConfig, build_translator_step,
                                          create_translator_state)

    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    r, n = dist.rank(), dist.world()
    full = _global_batch(n)
    batch = {k: torch.from_numpy(v[r:r + 1]).to(device) for k, v in full.items()}
    out: dict[str, float] = {}
    t0 = time.perf_counter()

    def done(name: str, value: float) -> None:
        nonlocal t0
        out[name] = value
        if dist.is_writer():
            print(f"dryrun_multichip({n}): {name} ok, {value:.4f} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()

    # translator GAN step: six Adams, both domain batches sharded
    mods = _translator(device)
    t_state = create_translator_state(mods, 1e-4)
    t_step = build_translator_step(TranslatorConfig(remat=False, compute_dtype=dtype),
                                   poly_schedule(1e-4, 50_000))
    loss = float(t_step(t_state, {"s_img": batch["s_img"], "s_lbl": batch["s_lbl"],
                                  "t_img": batch["t_img"]})["loss_g"])
    _check("translator", loss, mods)
    done("translator", loss)

    # batch-sharded two-scale eval: each rank scores its image
    frozen = nn.ModuleDict({"enc_s": mods["enc_s"], "dec_s2t": mods["dec_s2t"]})
    model = _seg_model("deeplab", device)
    ev = TwoScaleEvaluator(_eval_apply(model, False, dtype if dtype != torch.float32 else None),
                           NUM_CLASSES, CROP, (CROP[0] // 2, CROP[1] // 2), device)
    ev.update(batch["s_img"], batch["s_lbl"])
    miou = float(ev.score.get_scores()[0]["mean_iou"])
    if not math.isfinite(miou):
        raise RuntimeError(f"dryrun_multichip: non-finite eval mIoU {miou}")
    done("batch_eval", miou)

    # height-sharded two-scale eval: every rank holds rows of the one image
    from .spatial_ops import convert_spatial

    smodel = convert_spatial(_seg_model("deeplab", device))
    ev = TwoScaleEvaluator(_eval_apply(smodel, False, dtype if dtype != torch.float32 else None),
                           NUM_CLASSES, CROP, (CROP[0] // 2, CROP[1] // 2), device,
                           shard="spatial")
    ev.update(full["s_img"][:1], full["s_lbl"][:1])
    miou = float(ev.score.get_scores()[0]["mean_iou"])
    if not math.isfinite(miou):
        raise RuntimeError(f"dryrun_multichip: non-finite spatial eval mIoU {miou}")
    done("spatial_eval", miou)

    # self-training: centroids replicated, the scan over every rank's rows
    opt = sgd_grouped(model, 2.5e-4)
    st_state = create_seg_state(model, opt, 0, frozen,
                                Centroids.create(NUM_CLASSES, 256, device))
    st_step = build_selftrain_step(StepConfig(crop_hw=CROP, compute_dtype=dtype),
                                   poly_schedule(2.5e-4, 80_000))
    loss = float(st_step(st_state, batch)["loss"])
    _check("selftrain", loss, st_state.student, st_state.teacher)
    done("selftrain", loss)

    # warm-up (the flagship family), with the target-stats forward
    model = _seg_model("deeplab", device)
    state = create_seg_state(model, sgd_grouped(model, 2.5e-4), 0, frozen)
    step = build_warmup_step(StepConfig(crop_hw=CROP, tgt_stats_forward=True,
                                        compute_dtype=dtype), poly_schedule(2.5e-4, 80_000))
    loss = float(step(state, batch)["loss"])
    _check("warmup", loss, state.student, state.teacher)
    done("warmup", loss)

    # semiseg warm-up on HRNet+OCR: aux term, RGB input, no 10x head group
    hmodel = _seg_model("hrnet", device)
    h_state = create_seg_state(hmodel, sgd_grouped(hmodel, 1e-3, head_mult=1.0), 0)
    h_step = build_dg_step(StepConfig(crop_hw=CROP, aux_weight=0.1, rgb_input=True,
                                      compute_dtype=dtype), poly_schedule(1e-3, 80_000, 1.0))
    loss = float(h_step(h_state, {"s_img": batch["h_img"], "s_lbl": batch["h_lbl"]})["loss"])
    _check("semiseg", loss, h_state.student, h_state.teacher)
    done("semiseg", loss)
    return out


def warmup_rank(device_type: str) -> dict[str, list[float]]:
    """Two f32 warm-up steps (TF32 off) of the tiny DeepLab on this rank's
    share of a global batch of 2 images, every draw made by the step itself;
    {'losses', 'param_sums'} (float64 sums of the student's parameters)."""
    from ..train.optim import sgd_grouped
    from ..train.schedules import poly_schedule
    from ..train.state import create_seg_state
    from ..train.steps import StepConfig, build_warmup_step

    device = dist.local_device(device_type)
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        full = _global_batch(2, seed=1)
        b = 2 // dist.world()
        batch = {k: torch.from_numpy(v[dist.rank() * b:(dist.rank() + 1) * b]).to(device)
                 for k, v in full.items()}
        mods = _translator(device)
        model = _seg_model("deeplab", device)
        state = create_seg_state(model, sgd_grouped(model, 2.5e-4), 0, nn.ModuleDict(
            {"enc_s": mods["enc_s"], "dec_s2t": mods["dec_s2t"]}))
        step = build_warmup_step(StepConfig(crop_hw=CROP, beta=0.4, tgt_stats_forward=True,
                                            compute_dtype=torch.float32),
                                 poly_schedule(2.5e-4, 80_000))
        losses = [float(step(state, batch)["loss"]) for _ in range(2)]
        return {"losses": losses, "param_sums": [float(p.detach().double().sum())
                                                 for p in state.student.parameters()]}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def warmup_world(n: int, device: str = "cuda") -> dict[str, list[float]]:
    """``warmup_rank`` over ``n`` ranks (n divides 2): the same global batch
    and draws whatever ``n``, so worlds of 1 and 2 agree to rounding."""
    return dist.launch(warmup_rank, n, device, (device,))


def dryrun_multichip(n: int, device: str = "cuda") -> dict[str, float]:
    """One step of each family over ``n`` ranks (one process each; in this
    process for ``n`` = 1); rank 0's {family: loss, 'batch_eval': mIoU}."""
    return dist.launch(run_rank, n, device, (device,))


def main(argv=None) -> dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int, help="ranks (one device each)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    return dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
