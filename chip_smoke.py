#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (diga_tpu_torch) on one H100.

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout.  It builds the CUDA kernels from the
sources in the checkout and drives the port's two main paths at full
width on the card: the two-scale evaluation of DeepLabV2-R101 through
``diga_tpu_torch.cli.evaluate_val``, and the GTA5->Cityscapes warm-up
train step through ``diga_tpu_torch.cli.train_warm_up``.  Phases, any
failure of which exits non-zero:

  1. device: require CUDA; print the card's name and power limit
  2. build: nvcc every kernel source, all at once (``-Xptxas -v`` lines)
  3. GroupNorm kernels (B2a/B2b) against their plain versions on the card,
     at the eval and train paths' shapes plus two ragged ones, f32 (1e-5)
     and bf16 (3e-2); f32 channel sums at 1e-5 relative; two runs bitwise
     equal.  Distillation kernels (B1a/B1b) against theirs at the train
     path's (6, 512, 896, 19), a ragged (2, 7, 13, 19) and K=16, f32 and
     bf16: the loss at 1e-5 relative, the gradient within 1e-5 x max|ds| in
     f32 and one bf16 ulp in bf16, no teacher gradient, two runs bitwise
     equal
  4. tiny-depth model on the card against the same model on the CPU, f32,
     TF32 off: eval logits within 1e-3 of the CPU logits' largest
     magnitude; 3 warm-up steps with the same injected draws: losses at
     1e-4 relative, parameters within 1e-5, BN running statistics within
     1e-4 + 1e-3 x |value| (cuDNN's f32 conv algorithms)
  5. main path, eval: full-width R101 (random weights from a numpy seed,
     saved as student.pth), two synthetic 1024x2048 Cityscapes val images,
     evaluate_val in bf16; launch counts of every kernel read around it;
     finite two-scale logits whose argmax matches the dumped predictions;
     eval timing (GroupNorm kernel vs plain, in turns), peak memory
  6. main path, training: train_warm_up with preset gta2city_warmup at full
     width (R101, bf16, source 1 + 2 GTA5 images at 720x1280 and
     1052x1914, target 1 + 2 Cityscapes images at 512x1024 and 1024x2048,
     crop 512x896, random seeded translator, 3 steps); launch counts of
     every kernel read around it; finite losses; the exported student.pth
     loads strictly into the eval model.  Then the step timed on one batch
     on the card (distillation kernel vs plain, in turns): ms/step, source
     imgs/s, peak memory
  7. kernel timing: per-site GroupNorm and distillation device times
     against their byte bounds and plain versions; then the ``kernels``
     JSON line, the card line and the result line

``--profile DIR`` also writes torch.profiler tables and traces of one
two-scale eval and of one warm-up step into DIR, with their busy shares.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from diga_tpu_torch.cli import evaluate_val, train_warm_up
from diga_tpu_torch.configs.presets import get_preset
from diga_tpu_torch.data import cityscapes_dataset, synthetic
from diga_tpu_torch.eval.evaluator import two_scale_logits
from diga_tpu_torch.models import resnet_deeplab
from diga_tpu_torch.models.resnet_deeplab import DeepLabV2
from diga_tpu_torch.models.translator import ImgDecoder, ImgEncoder
from diga_tpu_torch.ops import distill as D
from diga_tpu_torch.ops import group_norm as G
from diga_tpu_torch.ops import mixing, native
from diga_tpu_torch.ops import photometric as P
from diga_tpu_torch.ops.losses import distillation_loss as plain_distillation_loss
from diga_tpu_torch.ops.metrics import confusion_update
from diga_tpu_torch.train.build import build_eval, build_experiment
from diga_tpu_torch.train.loop import make_train_iterator, to_device
from diga_tpu_torch.train.optim import sgd_grouped
from diga_tpu_torch.train.schedules import poly_schedule
from diga_tpu_torch.train.state import create_seg_state
from diga_tpu_torch.train.steps import StepConfig, build_warmup_step
from diga_tpu_torch.utils.checkpoint import export_role_keyed

# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s and
# f32 non-tensor-core FLOP/s, the rate the GroupNorm arithmetic runs at
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
GN_SITES = [(1, 129, 257, 256), (1, 65, 129, 256)]  # eval ASPP GN at full / half scale
GN_TRAIN_SITE = (6, 65, 113, 256)  # the warm-up teacher's ASPP GN, crop 512x896
CHECK_SHAPES = GN_SITES + [GN_TRAIN_SITE, (2, 17, 29, 256), (2, 8, 16, 64)]
DISTILL_SHAPE = (6, 512, 896, 19)  # the warm-up path's upsampled [clean; aug] logits
DISTILL_CHECK_SHAPES = [DISTILL_SHAPE, (2, 7, 13, 19), (2, 9, 11, 16)]
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
PRESET = "gta2city_warmup"
OUT_HW, DS_HW = (1024, 2048), (512, 1024)
N_IMAGES = 2
SEED = 0
TRAIN_STEPS = 3
TPU_KERNELS = {  # name: (id, source, the TPU kernel it replaces)
    "distill_loss": ("B1a", "diga_tpu_torch/csrc/distill.cu", "diga_tpu/ops/pallas_kernels.py:35"),
    "distill_grad": ("B1b", "diga_tpu_torch/csrc/distill.cu", "diga_tpu/ops/pallas_kernels.py:85"),
    "group_norm_stats": ("B2a", "diga_tpu_torch/csrc/group_norm.cu", "diga_tpu/ops/pallas_gn.py:53"),
    "group_norm_apply": ("B2b", "diga_tpu_torch/csrc/group_norm.cu", "diga_tpu/ops/pallas_gn.py:74"),
}


def launches() -> dict:
    return {**G.launches, **D.launches}


def reset_launches() -> None:
    G.reset_launches()
    D.reset_launches()


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def seeded_state_dict(model: DeepLabV2, seed: int) -> dict:
    """Random weights for ``model``'s keys from a numpy seed: kaiming-scaled
    convs and linears, BN statistics near (0, 1), small residual-branch BN
    scales so activations stay bounded through 33 bottlenecks."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in model.state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = v.clone()
            continue
        if len(shape) >= 2:  # conv (O, I, kh, kw) or linear (O, I)
            fan_in = int(np.prod(shape[1:]))
            a = rng.normal(size=shape) * math.sqrt(2.0 / fan_in)
        elif k.endswith("running_mean") or k.endswith(".bias"):
            a = rng.normal(size=shape) * 0.1
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 1.5, size=shape)
        elif ".bn3." in k:
            a = rng.uniform(0.1, 0.3, size=shape)
        else:  # BN / GN scales
            a = rng.uniform(0.8, 1.2, size=shape)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


def gn_inputs(shape, dtype, seed, device="cuda"):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.normal(size=shape) + rng.uniform(-2, 2, size=(c,))).astype(np.float32)
    scale = (rng.normal(size=(c,)) * 0.1 + 1.0).astype(np.float32)
    bias = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    return (torch.from_numpy(x).to(device, dtype), torch.from_numpy(scale).to(device),
            torch.from_numpy(bias).to(device), x)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def close(a: torch.Tensor, b: torch.Tensor, tol: float) -> bool:
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= tol + tol * b.abs()).all())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build() -> None:
    t0 = time.perf_counter()
    logs = native.build()
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}")
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s", flush=True)


def phase_kernels_vs_plain() -> dict:
    """Returns, per kernel, the largest |kernel - plain| at the path's sites (bf16)."""
    errs = {name: 0.0 for name in G.launches}  # the GroupNorm pair
    for i, shape in enumerate(CHECK_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            x, sc, bi, x_np = gn_inputs(shape, dtype, seed=100 + i)
            tol = TOL[dtype]
            with torch.inference_mode():
                runs = []
                for _ in range(2):
                    st = G.group_norm_stats(x, sc, bi)
                    runs.append((*st, G.group_norm_apply(x, st[2], st[3])))
                s, s2, mul, add, y = runs[0]
                ps, ps2, pmul, padd = G.group_norm_stats_plain(x, sc, bi)
                py_apply = G.group_norm_apply_plain(x, mul, add)
                py = G.group_norm_plain(x, sc, bi)
            torch.cuda.synchronize()
            tag = f"shape={shape} dtype={str(dtype).split('.')[-1]}"
            require(all(torch.equal(a, b) for a, b in zip(*runs)),
                    f"kernel results differ between two runs at {tag}")
            require(y.dtype == dtype and y.shape == x.shape, f"output dtype/shape at {tag}")
            if dtype == torch.float32:
                xq = x_np.astype(np.float64)
                abs_sum = torch.from_numpy(np.abs(xq).sum(axis=(1, 2))).to(s.device)
                sq_sum = torch.from_numpy((xq * xq).sum(axis=(1, 2))).to(s.device)
                e_s = float(((s.double() - ps.double()).abs() / abs_sum).max())
                e_s2 = float(((s2.double() - ps2.double()).abs() / sq_sum).max())
                require(e_s <= 1e-5 and e_s2 <= 1e-5,
                        f"channel sums off at {tag}: rel {e_s:.2e}, {e_s2:.2e}")
            require(close(mul, pmul, tol) and close(add, padd, tol), f"mul/add off at {tag}")
            require(close(y, py_apply, tol), f"apply kernel off at {tag}")
            require(close(y, py, tol), f"group_norm off at {tag}")
            e_stats = max(max_err(mul, pmul), max_err(add, padd))
            e_apply = max_err(y, py_apply)
            print(f"check {tag}: stats max_abs_err={e_stats:.3e} apply max_abs_err={e_apply:.3e} "
                  f"group_norm max_abs_err={max_err(y, py):.3e} tol={tol} bitwise-repeatable",
                  flush=True)
            if shape in GN_SITES + [GN_TRAIN_SITE] and dtype == torch.bfloat16:
                errs["group_norm_stats"] = max(errs["group_norm_stats"], e_stats)
                errs["group_norm_apply"] = max(errs["group_norm_apply"], e_apply)
    return errs


def phase_model_gpu_vs_cpu() -> None:
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        layers = (1, 1, 1, 1)
        sd = seeded_state_dict(DeepLabV2(19, layers), SEED + 1)
        x = np.random.default_rng(SEED + 2).normal(size=(1, 129, 257, 3)).astype(np.float32)
        logits = {}
        for dev in ("cpu", "cuda"):
            model = DeepLabV2(19, layers)
            model.load_state_dict(sd, strict=True)
            model.eval().to(dev)
            with torch.inference_mode():
                logits[dev] = model(torch.from_numpy(x).to(dev).permute(0, 3, 1, 2))[2].cpu()
        scale = float(logits["cpu"].abs().max())
        err = max_err(logits["cuda"], logits["cpu"])
        require(math.isfinite(err) and err <= 1e-3 * scale,
                f"tiny model on the card vs the CPU: max_abs_err {err:.3e} > 1e-3 x {scale:.3e}")
        print(f"model gpu-vs-cpu layers={layers} f32 tf32=off: max_abs_err={err:.3e} "
              f"max|logit|={scale:.3e} tol=1e-3*max|logit|", flush=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def phase_main_path(work: str) -> tuple[dict, dict]:
    """evaluate_val at full width; returns (launch counts, fixture paths)."""
    root = os.path.join(work, "city")
    t0 = time.perf_counter()
    val_img, val_lbl = synthetic.make_cityscapes_fixture(
        root, n=N_IMAGES, h=OUT_HW[0], w=OUT_HW[1], split="val")
    wdir = os.path.join(work, "weights")
    export_role_keyed(wdir, {"student": seeded_state_dict(DeepLabV2(19), SEED)})
    print(f"main path setup (fixture + student.pth): {time.perf_counter() - t0:.1f} s", flush=True)
    dump = os.path.join(work, "preds")
    argv = ["--preset", PRESET, "--weight_dir", wdir, "--eval_limit", str(N_IMAGES),
            "--target_root", root, "--val_img_list", val_img, "--val_lbl_list", val_lbl,
            "--dump_preds", dump]

    reset_launches()
    t0 = time.perf_counter()
    results = evaluate_val.main(argv)
    torch.cuda.synchronize()
    counts = launches()
    print(f"main path: evaluate_val {N_IMAGES} images in {time.perf_counter() - t0:.1f} s "
          f"(model build and first-call set-up included); launches={counts}", flush=True)
    gn = N_IMAGES * 2 * 6  # images x scales x ASPP GroupNorm sites
    want = {"group_norm_stats": gn, "group_norm_apply": gn, "distill_loss": 0, "distill_grad": 0}
    require(counts == want, f"kernel launches on the eval path {counts}, expected {want}")
    scores = results.get("cityscapes", {})
    require({"overall_acc", "mean_acc", "fwavacc", "mean_iou"} <= set(scores),
            f"no mIoU dict from evaluate_val: {results}")
    require(0.0 <= scores["mean_iou"] <= 1.0, f"mean_iou out of range: {scores}")
    print("main path scores: " + json.dumps({k: float(v) for k, v in scores.items()}))
    return counts, {"root": root, "val_img": val_img, "val_lbl": val_lbl,
                    "wdir": wdir, "dump": dump}


def check_outputs(eval_apply, paths: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """Finite two-scale logits whose argmax is what evaluate_val dumped."""
    ds = cityscapes_dataset(paths["root"], paths["val_img"], paths["val_lbl"], resize_hw=OUT_HW)
    sample = ds[0]
    img = torch.from_numpy(sample["image"][None]).cuda()
    lbl = torch.from_numpy(sample["label"][None].astype(np.int64)).cuda()
    with torch.inference_mode():
        merged = two_scale_logits(eval_apply, img, OUT_HW, DS_HW)
    require(tuple(merged.shape) == (1, *OUT_HW, 19), f"logits shape {tuple(merged.shape)}")
    require(bool(torch.isfinite(merged).all()), "non-finite two-scale logits")
    pred = merged.argmax(-1)[0].cpu().numpy()
    base = os.path.splitext(os.path.basename(sample["name"]))[0]
    dumped = np.array(Image.open(os.path.join(paths["dump"], base + ".png")))
    agree = float((dumped == pred).mean())
    require(agree >= 0.999, f"dumped predictions agree with recomputed argmax on {agree:.5f}")
    print(f"outputs: logits {tuple(merged.shape)} {merged.dtype} finite, "
          f"max|logit|={float(merged.float().abs().max()):.3e}, "
          f"argmax agrees with the dumped prediction on {agree:.6f} of pixels", flush=True)
    return img, lbl


def eval_ms_per_img(eval_apply, img, lbl, n: int) -> float:
    conf = torch.zeros((19, 19), dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for _ in range(n):
            merged = two_scale_logits(eval_apply, img, OUT_HW, DS_HW)
            conf = confusion_update(conf, lbl, merged.argmax(-1), 19)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def phase_eval_timing(eval_apply, img, lbl, card: str) -> float:
    """Two-scale ms/img with the GroupNorm kernel and with its plain version,
    in turns; returns the kernel's."""
    for _ in range(2):  # warm-up: cuDNN set-up, allocator
        eval_ms_per_img(eval_apply, img, lbl, 1)
    torch.cuda.reset_peak_memory_stats()
    times = {"kernel": [], "plain": []}
    for variant in ("kernel", "plain", "plain", "kernel"):
        resnet_deeplab.group_norm = G.group_norm if variant == "kernel" else G.group_norm_plain
        try:
            times[variant].append(eval_ms_per_img(eval_apply, img, lbl, 5))
        finally:
            resnet_deeplab.group_norm = G.group_norm
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    k, p = (float(np.mean(times[v])) for v in ("kernel", "plain"))
    print(f"eval two-scale R101 bf16 batch 1 {OUT_HW[0]}x{OUT_HW[1]}+{DS_HW[0]}x{DS_HW[1]}: "
          f"ms/img gn=kernel {k:.2f} {times['kernel']} gn=plain {p:.2f} {times['plain']} "
          f"peak_mem_MiB={peak_mb:.0f} | card={card}", flush=True)
    return k


def device_time_us(events) -> float:
    """Summed self time of the device-side events (kernels, copies) of a
    torch.profiler ``key_averages()``, in µs."""
    from torch.autograd import DeviceType

    return sum(getattr(e, "self_device_time_total", 0.0) for e in events
               if e.device_type == DeviceType.CUDA)


def time_us(fn, arg_sets, iters: int = 100) -> tuple[float, float]:
    """(device µs, call µs) per call over ``iters`` calls cycling through
    ``arg_sets`` (together larger than the 50 MB L2, so each call reads
    cold data).  Device µs: the kernels' own durations (torch.profiler,
    CUPTI).  Call µs: CUDA events around back-to-back calls, which is
    the host's launch cost where that exceeds the device time."""
    from torch.profiler import ProfilerActivity, profile

    def loop():
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])

    loop()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    loop()
    end.record()
    torch.cuda.synchronize()
    call = start.elapsed_time(end) / iters * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loop()
        torch.cuda.synchronize()
    dev = device_time_us(prof.key_averages()) / iters
    require(dev > 0, "torch.profiler recorded no device time")
    return dev, call


def bound_us(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e6
    t_ops = n_flops / F32_FLOPS_PER_S * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_gn_timing(card: str) -> dict:
    """Per-site times; returns the kernels' numbers at the full-scale site."""
    dtype = torch.bfloat16
    per_kernel = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for shape in GN_SITES + [GN_TRAIN_SITE]:
        b, h, w, c = shape
        numel = b * h * w * c
        xb = numel * 2
        n_buf = max(2, math.ceil(120e6 / xb))
        xs = [(torch.randn(shape, generator=gen, device="cuda") + 1.0).to(dtype)
              for _ in range(n_buf)]
        sc = torch.rand(c, generator=gen, device="cuda") + 0.5
        bi = torch.randn(c, generator=gen, device="cuda") * 0.1
        sc16, bi16 = sc.to(dtype), bi.to(dtype)
        with torch.inference_mode():
            ma = [G.group_norm_stats_plain(x, sc, bi)[2:] for x in xs]
            full = [(x, sc, bi) for x in xs]
            app = [(x, m, a) for x, (m, a) in zip(xs, ma)]
            lib_app = [(a[:, None, None, :], x, m[:, None, None, :]) for x, (m, a) in zip(xs, ma)]
            nchw = [(x.permute(0, 3, 1, 2), 32, sc16, bi16, 1e-5) for x in xs]
            t = {
                "gn": time_us(G.group_norm, full),
                "gn_plain": time_us(G.group_norm_plain, full),
                "gn_library": time_us(F.group_norm, nchw),
                "stats": time_us(G.group_norm_stats, full),
                "stats_plain": time_us(G.group_norm_stats_plain, full),
                "apply": time_us(G.group_norm_apply, app),
                "apply_plain": time_us(G.group_norm_apply_plain, app),
                "apply_library": time_us(torch.addcmul, lib_app),
            }
        small = b * c * (2 * 4 + 2 * 2)  # Σx, Σx² f32 + mul, add bf16
        bounds = {
            "gn": bound_us(2 * xb + 2 * c * 4, 5 * numel),
            "stats": bound_us(xb + 2 * c * 4 + small, 3 * numel),
            "apply": bound_us(2 * xb + b * c * 2 * 2, 2 * numel),
        }

        def fmt(key):
            dev, call = t[key]
            return f"{dev:.2f} (call {call:.2f})"

        print(f"gn_site shape={shape} bf16, device us (call us): group_norm {fmt('gn')} "
              f"bound {bounds['gn'][0]:.2f} by {bounds['gn'][1]} share "
              f"{bounds['gn'][0] / t['gn'][0]:.2f}, plain {fmt('gn_plain')}, "
              f"F.group_norm {fmt('gn_library')} | stats {fmt('stats')} bound "
              f"{bounds['stats'][0]:.2f}, plain {fmt('stats_plain')} | apply {fmt('apply')} "
              f"bound {bounds['apply'][0]:.2f}, plain {fmt('apply_plain')}, torch.addcmul "
              f"{fmt('apply_library')} | card={card}", flush=True)
        if shape == GN_SITES[0]:
            for name, key, lib in (("group_norm_stats", "stats", None),
                                   ("group_norm_apply", "apply", "apply_library")):
                per_kernel[name] = {
                    "shape": list(shape), "ms": t[key][0] / 1e3,
                    "plain_ms": t[key + "_plain"][0] / 1e3,
                    "bound_ms": bounds[key][0] / 1e3, "bound_by": bounds[key][1],
                    "library_ms": None if lib is None else t[lib][0] / 1e3,
                    "call_ms": t[key][1] / 1e3}
        del xs, ma, full, app, lib_app, nchw
    return per_kernel


def phase_profile(eval_apply, img, lbl, ms_per_img: float, out_dir: str) -> None:
    """Device time of one two-scale eval by op (torch.profiler); the busy
    share is that device time over the unprofiled ms/img of phase 6."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eval_ms_per_img(eval_apply, img, lbl, 1)
    avgs = prof.key_averages()
    table = avgs.table(sort_by="self_cuda_time_total", row_limit=60)
    with open(os.path.join(out_dir, "eval_profile.txt"), "w") as f:
        f.write(table)
    prof.export_chrome_trace(os.path.join(out_dir, "eval_trace.json"))
    dev_ms = device_time_us(avgs) / 1e3
    print(f"profile: one two-scale eval, device time {dev_ms:.2f} ms; busy share "
          f"{dev_ms / ms_per_img:.3f} of {ms_per_img:.2f} ms/img; table and trace in {out_dir}",
          flush=True)
    print("\n".join(table.splitlines()[:30]))


# ---------------------------------------------------------------------------
# the distillation kernels and the training path
# ---------------------------------------------------------------------------

def distill_inputs(shape, dtype, seed, device="cuda"):
    rng = np.random.default_rng(seed)
    t = (rng.normal(size=shape) * 3).astype(np.float32)
    s = (rng.normal(size=shape) * 3).astype(np.float32)
    return torch.from_numpy(t).to(device, dtype), torch.from_numpy(s).to(device, dtype)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(1e-30))) - 7)


def phase_distill_vs_plain() -> dict:
    """Returns, per kernel, the largest |kernel - plain| at the path's shape (bf16)."""
    errs = {"distill_loss": 0.0, "distill_grad": 0.0}
    g = torch.tensor(0.5, device="cuda")  # lambda_distil, the step's incoming gradient
    for i, shape in enumerate(DISTILL_CHECK_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            t, s = distill_inputs(shape, dtype, seed=200 + i)
            loss = [D.distillation_loss_kernel(t, s, 0.5) for _ in range(2)]
            ds = [D.distillation_grad_kernel(t, s, g, 0.5) for _ in range(2)]
            ref = D.distillation_loss_plain(t, s, 0.5)
            ref_ds = D.distillation_grad_plain(t, s, g, 0.5)
            tt, st = t.clone().requires_grad_(True), s.clone().requires_grad_(True)
            D.distillation_loss(tt, st, 0.5).backward()
            torch.cuda.synchronize()
            tag = f"shape={shape} dtype={str(dtype).split('.')[-1]}"
            require(torch.equal(loss[0], loss[1]) and torch.equal(ds[0], ds[1]),
                    f"distillation kernels differ between two runs at {tag}")
            require(ds[0].dtype == dtype and ds[0].shape == s.shape, f"ds dtype/shape at {tag}")
            require(tt.grad is None and st.grad is not None, f"teacher got a gradient at {tag}")
            e_loss = abs(float(loss[0]) - float(ref))
            require(e_loss <= 1e-5 * abs(float(ref)),
                    f"loss off at {tag}: {float(loss[0])!r} vs {float(ref)!r}")
            diff = (ds[0].float() - ref_ds.float()).abs()
            scale = float(ref_ds.float().abs().max())
            # f32: 1e-5 of the largest gradient; bf16: one bf16 ulp at the
            # largest gradient (where softmax(s) ~ softmax(t) the difference
            # cancels, and a few-ulp f32 difference between expf and torch's
            # exp can move a small element across one rounding boundary)
            tol_v = 1e-5 * scale if dtype == torch.float32 else float(bf16_ulp(torch.tensor(scale)))
            ok = float(diff.max()) <= tol_v
            tol = (f"1e-5*max|ds|={tol_v:.3e}" if dtype == torch.float32
                   else f"one bf16 ulp of max|ds|={tol_v:.3e}")
            require(ok, f"ds off at {tag}: max_abs_err {float(diff.max()):.3e}, tol {tol}")
            print(f"check distill {tag}: loss {float(loss[0]):.6f} rel_err "
                  f"{e_loss / abs(float(ref)):.2e} | ds max_abs_err {float(diff.max()):.3e} "
                  f"tol {tol} | teacher grad None | bitwise-repeatable", flush=True)
            if shape == DISTILL_SHAPE and dtype == torch.bfloat16:
                errs = {"distill_loss": e_loss, "distill_grad": float(diff.max())}
            del t, s, loss, ds, ref, ref_ds, tt, st
    return errs


def tiny_warmup(device: str, model_sd: dict, translator_sd: dict):
    """3-step-ready tiny warm-up state on ``device`` and its step (f32)."""
    student = DeepLabV2(19, (1, 1, 1, 1), droprate=0.0)
    student.load_state_dict(model_sd, strict=True)
    enc, dec = ImgEncoder(dim=16, n_res=1), ImgDecoder(dim=64, n_res=1)
    enc.load_state_dict(translator_sd["enc_s"], strict=True)
    dec.load_state_dict(translator_sd["dec_s2t"], strict=True)
    student.to(device)
    opt = sgd_grouped(student, 2.5e-4)
    state = create_seg_state(student, opt, SEED, torch.nn.ModuleDict(
        {"enc_s": enc, "dec_s2t": dec}).to(device))
    cfg = StepConfig(crop_hw=(64, 128), beta=0.4, tgt_stats_forward=True,
                     compute_dtype=torch.float32)
    return state, build_warmup_step(cfg, poly_schedule(2.5e-4, 100))


def phase_warmup_gpu_vs_cpu() -> None:
    """The tiny warm-up step on the card against the CPU, same inputs and draws."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        torch.manual_seed(SEED + 3)
        model_sd = DeepLabV2(19, (1, 1, 1, 1), droprate=0.0).state_dict()
        translator_sd = {"enc_s": ImgEncoder(dim=16, n_res=1).state_dict(),
                         "dec_s2t": ImgDecoder(dim=64, n_res=1).state_dict()}
        card, host = "cuda", "cpu"
        runs = {dev: tiny_warmup(dev, model_sd, translator_sd) for dev in (host, card)}
        rng = np.random.default_rng(SEED + 4)
        gen = torch.Generator().manual_seed(SEED + 5)
        losses = {dev: [] for dev in runs}
        for _ in range(TRAIN_STEPS):
            lbl = rng.integers(0, 19, size=(2, 64, 128)).astype(np.int32)
            lbl[:, :, :8] = 255
            batch = {"s_img": (rng.normal(size=(2, 64, 128, 3)) * 0.5).astype(np.float32),
                     "s_lbl": lbl,
                     "t_img": (rng.normal(size=(2, 64, 128, 3)) * 0.5).astype(np.float32)}
            draws = P.draw(gen, 2)
            selection = mixing.sample_half_classes(torch.from_numpy(lbl), gen, 19)
            for dev, (state, step) in runs.items():
                m = step(state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
                         selection=selection.to(dev),
                         photometric_draws={k: v.to(dev) for k, v in draws.items()})
                losses[dev].append({k: float(v) for k, v in m.items()})
        for a, b in zip(losses[card], losses[host]):
            for k in a:
                require(math.isfinite(a[k]) and abs(a[k] - b[k]) <= 1e-4 * abs(b[k]),
                        f"tiny warm-up {k} on the card {a[k]!r} vs the CPU {b[k]!r}")
        sd = {dev: {k: v.detach().cpu() for k, v in state.student.state_dict().items()}
              for dev, (state, _) in runs.items()}
        # parameters within 1e-5 (updates are lr x grad); running statistics
        # within 1e-4 + 1e-3 x |value|: cuDNN may time Winograd or FFT
        # algorithms for the f32 convs, about 1e-5 relative error each
        e_param = e_stat = 0.0
        for k, v in sd[host].items():
            if k.endswith("num_batches_tracked"):
                continue
            d = (sd[card][k] - v).abs()
            if "running" in k:
                e_stat = max(e_stat, float((d / (1e-4 + 1e-3 * v.abs())).max()))
            else:
                e_param = max(e_param, float(d.max()))
        require(e_param <= 1e-5 and e_stat <= 1.0,
                f"tiny warm-up state on the card vs the CPU: params {e_param:.3e} (tol 1e-5), "
                f"running stats {e_stat:.3e} of their tolerance 1e-4 + 1e-3 x |value|")
        print(f"warm-up gpu-vs-cpu layers=(1,1,1,1) crop 64x128 f32 tf32=off {TRAIN_STEPS} "
              f"steps: losses {[round(x['loss'], 6) for x in losses[card]]} vs "
              f"{[round(x['loss'], 6) for x in losses[host]]} (tol 1e-4 rel), params "
              f"max_abs_err {e_param:.3e} (tol 1e-5), running stats at {e_stat:.3f} of their "
              f"tolerance (1e-4 + 1e-3 x |value|)", flush=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def phase_train_main_path(work: str) -> tuple[dict, dict]:
    """train_warm_up at full width; returns (launch counts, the fixtures' data paths)."""
    t0 = time.perf_counter()
    gta_root, city_root = os.path.join(work, "gta"), os.path.join(work, "city_train")
    gta_list = synthetic.make_gta5_fixture(gta_root, n=3, h=1052, w=1914)
    img_list, lbl_list = synthetic.make_cityscapes_fixture(city_root, n=3, h=1024, w=2048,
                                                           split="train")
    wd = os.path.join(work, "warmup")
    print(f"train path setup (GTA5 + Cityscapes fixtures): {time.perf_counter() - t0:.1f} s",
          flush=True)
    argv = ["--preset", PRESET, "--work_dir", wd, "--num_steps", str(TRAIN_STEPS),
            "--source_root", gta_root, "--source_list", gta_list,
            "--target_root", city_root, "--target_img_list", img_list,
            "--target_lbl_list", lbl_list]

    reset_launches()
    t0 = time.perf_counter()
    result = train_warm_up.main(argv)
    torch.cuda.synchronize()
    counts = launches()
    print(f"main path: train_warm_up {TRAIN_STEPS} steps in {time.perf_counter() - t0:.1f} s "
          f"(model build, cuDNN autotuning and data loading included); launches={counts}",
          flush=True)
    want = {"distill_loss": TRAIN_STEPS, "distill_grad": TRAIN_STEPS,
            "group_norm_stats": 6 * TRAIN_STEPS, "group_norm_apply": 6 * TRAIN_STEPS}
    require(counts == want, f"kernel launches on the train path {counts}, expected {want}")
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]  # the trainer logs step 0 of every 50
    require([r["step"] for r in recs] == [0], f"metrics.jsonl: {recs}")
    last = {"step": TRAIN_STEPS - 1, **result.last_metrics}
    for r in (recs[0], last):
        require(all(math.isfinite(r[k]) for k in ("loss", "loss_semseg", "loss_distil")),
                f"non-finite training loss: {r}")
    build_eval(get_preset(PRESET), os.path.join(wd, "weights"), torch.device("cuda"))
    print("main path losses: " + json.dumps([{k: r[k] for k in ("step", "loss", "loss_semseg",
                                                                "loss_distil")}
                                             for r in (recs[0], last)])
          + "; student.pth loads strictly into the eval model", flush=True)
    return counts, {"source_root": gta_root, "source_list": gta_list, "target_root": city_root,
                    "target_img_list": img_list, "target_lbl_list": lbl_list}


def step_ms(state, step, batch, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def phase_train_timing(data_paths: dict, card: str, profile_dir: str | None) -> dict:
    """ms/step of the warm-up step on one batch on the card, in turns with
    the distillation kernels and with the plain PyTorch distillation under
    autograd (``ops/losses.py``); imgs/s, peak memory, optional profile."""
    base = get_preset(PRESET)
    cfg = dataclasses.replace(base, data=dataclasses.replace(base.data, **data_paths))
    state, step, _ = build_experiment(cfg, torch.device("cuda"))
    it, loaders = make_train_iterator(cfg, with_target=True)
    try:
        batch = to_device(next(it), torch.device("cuda"))
    finally:
        for ld in loaders:
            ld.stop()
    batch.pop("t_lbl")
    n_src = batch["s_img"].shape[0]
    step_ms(state, step, batch, 3)  # warm-up: cuDNN autotuning, allocator
    torch.cuda.reset_peak_memory_stats()
    times = {"kernel": [], "plain": []}
    kernel_fn = D.distillation_loss
    for variant in ("kernel", "plain", "plain", "kernel"):
        D.distillation_loss = kernel_fn if variant == "kernel" else plain_distillation_loss
        try:
            times[variant].append(step_ms(state, step, batch, 5))
        finally:
            D.distillation_loss = kernel_fn
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    k, p = (float(np.mean(times[v])) for v in ("kernel", "plain"))
    out = {"ms_per_step": k, "ms_per_step_plain_distill": p, "peak_mem_GiB": peak_gb,
           "gta2city_warmup_train_imgs_per_sec_per_chip": n_src / (k / 1e3)}
    print(f"train warm-up step R101 bf16 source {n_src} + target {batch['t_img'].shape[0]} "
          f"imgs crop {tuple(batch['s_img'].shape[1:3])}: ms/step distill=kernel {k:.2f} "
          f"{times['kernel']} distill=plain {p:.2f} {times['plain']} peak_mem_GiB={peak_gb:.2f} "
          f"| card={card}", flush=True)
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(profile_dir, exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            step_ms(state, step, batch, 1)
        avgs = prof.key_averages()
        table = avgs.table(sort_by="self_cuda_time_total", row_limit=60)
        by_shape = prof.key_averages(group_by_input_shape=True).table(
            sort_by="self_cuda_time_total", row_limit=40)
        with open(os.path.join(profile_dir, "train_step_profile.txt"), "w") as f:
            f.write(table + "\n" + by_shape)
        prof.export_chrome_trace(os.path.join(profile_dir, "train_step_trace.json"))
        dev_ms = device_time_us(avgs) / 1e3
        out["device_ms_per_step"] = dev_ms
        out["busy_share"] = dev_ms / k
        print(f"profile: one warm-up step, device time {dev_ms:.2f} ms; busy share "
              f"{dev_ms / k:.3f} of {k:.2f} ms/step; table and trace in {profile_dir}", flush=True)
        print("\n".join(table.splitlines()[:40]))
        print("\n".join(by_shape.splitlines()[:16]))
    print(json.dumps({"metric": "gta2city_warmup_train_imgs_per_sec_per_chip",
                      "value": out["gta2city_warmup_train_imgs_per_sec_per_chip"],
                      "unit": "imgs/sec", "ms_per_step": k, "card": card}), flush=True)
    return out


def phase_distill_timing(card: str) -> dict:
    """B1a/B1b device times at the path's shape against their bounds and plain versions."""
    n_buf = 2  # 2 x 2 x 52.3 MB of logits: more than the 50 MB L2
    pairs = [distill_inputs(DISTILL_SHAPE, torch.bfloat16, seed=300 + i) for i in range(n_buf)]
    g = torch.tensor(0.5, device="cuda")
    loss_args = [(t, s, 0.5) for t, s in pairs]
    grad_args = [(t, s, g, 0.5) for t, s in pairs]
    t = {
        "distill_loss": time_us(D.distillation_loss_kernel, loss_args),
        "distill_loss_plain": time_us(D.distillation_loss_plain, loss_args),
        "distill_grad": time_us(D.distillation_grad_kernel, grad_args),
        "distill_grad_plain": time_us(D.distillation_grad_plain, grad_args),
    }
    numel = math.prod(DISTILL_SHAPE)
    xb = numel * 2
    # reads t and s once (and writes ds); about 8 f32 operations per element
    # for the two softmaxes and the CE terms (exp and log counted as one)
    bounds = {"distill_loss": bound_us(2 * xb + 4, 8 * 2 * numel),
              "distill_grad": bound_us(3 * xb + 4, 8 * 2 * numel)}
    per_kernel = {}
    for name in ("distill_loss", "distill_grad"):
        dev, call = t[name]
        print(f"distill shape={DISTILL_SHAPE} bf16 {name}: device {dev:.2f} us (call "
              f"{call:.2f}) bound {bounds[name][0]:.2f} us by {bounds[name][1]} share "
              f"{bounds[name][0] / dev:.2f}, plain {t[name + '_plain'][0]:.2f} us (call "
              f"{t[name + '_plain'][1]:.2f}) | card={card}", flush=True)
        per_kernel[name] = {"shape": list(DISTILL_SHAPE), "ms": dev / 1e3,
                            "plain_ms": t[name + "_plain"][0] / 1e3,
                            "bound_ms": bounds[name][0] / 1e3, "bound_by": bounds[name][1],
                            "library_ms": None, "call_ms": call / 1e3}
    return per_kernel


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=str, default=None,
                    help="directory for torch.profiler tables and traces of one eval and "
                         "one warm-up step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs on the card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()

    # 1. device
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} x{torch.cuda.device_count()} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    # 2. build
    phase_build()
    # 3. kernels against their plain versions
    errs = {**phase_kernels_vs_plain(), **phase_distill_vs_plain()}
    # 4. tiny models on the card against the CPU
    phase_model_gpu_vs_cpu()
    phase_warmup_gpu_vs_cpu()
    counts = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        # 5. main path: the eval
        counts["evaluate_val"], paths = phase_main_path(work)
        eval_apply, eval_model = build_eval(get_preset(PRESET), paths["wdir"],
                                            torch.device("cuda"))
        img, lbl = check_outputs(eval_apply, paths)
        ms_per_img = phase_eval_timing(eval_apply, img, lbl, card)
        if args.profile:
            phase_profile(eval_apply, img, lbl, ms_per_img, args.profile)
        del eval_apply, eval_model, img, lbl
        gc.collect()
        torch.cuda.empty_cache()
        # 6. main path: the warm-up train step
        counts["train_warm_up"], data_paths = phase_train_main_path(work)
        gc.collect()
        torch.cuda.empty_cache()
        phase_train_timing(data_paths, card, args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    # 7. kernel timing and the record lines
    per_kernel = {**phase_gn_timing(card), **phase_distill_timing(card)}
    for path, c in counts.items():
        used = [k for k, (_, src, _) in TPU_KERNELS.items()
                if path == "train_warm_up" or src.endswith("group_norm.cu")]
        require(all(c[k] > 0 for k in used), f"a kernel of the {path} path never launched: {c}")
    kernels = []
    for kname, (kid, source, replaces) in TPU_KERNELS.items():
        kernels.append({"name": kname, "id": kid, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts["train_warm_up"][kname],
                        "launches_by_path": {p: c[kname] for p, c in counts.items()},
                        "max_abs_err": errs[kname], **per_kernel[kname]})
    print(f"total chip_smoke time {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
