#!/usr/bin/env python3
"""Times the synced BatchNorm against cuDNN's on one card.

    python3 sync_bn_probe.py

In a world of one NCCL rank (``parallel/dist.py``), at the BatchNorm
shapes of the warm-up step's R101 (batch 6, crop 512x896, bf16,
channels_last, frozen affine): ``SyncBatchNorm2d``'s training forward and
backward, and its forward alone (the teacher's and the target-stats
forwards), against ``nn.BatchNorm2d``'s (cuDNN) on the same input; then
the NCCL all-reduce of the warm-up student's 43 M f32 gradients and of one
BatchNorm's 2C + 1 statistics.  Host clock around 20 calls after 3, ending
in ``torch.cuda.synchronize()``: ms per call.  Exits non-zero without a
card.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch
import torch.nn as nn

from diga_tpu_torch.parallel import dist
from diga_tpu_torch.parallel.sync_bn import SyncBatchNorm2d

# (batch, channels, height, width) of the warm-up's BNs at crop 512x896:
# the stem, layer1-4's inner and outer widths
SHAPES = [(6, 64, 256, 448), (6, 64, 128, 224), (6, 256, 128, 224), (6, 128, 64, 112),
          (6, 512, 64, 112), (6, 256, 65, 113), (6, 1024, 65, 113), (6, 512, 65, 113),
          (6, 2048, 65, 113)]
ITERS = 20


def ms_per_call(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / ITERS * 1e3


def probe() -> None:
    torch.manual_seed(0)
    totals = {"cudnn": [0.0, 0.0], "sync": [0.0, 0.0]}
    for shape in SHAPES:
        x = (torch.randn(shape, device="cuda") * 2 + 1).to(torch.bfloat16).to(
            memory_format=torch.channels_last).requires_grad_(True)
        g = torch.randn_like(x)
        bn = SyncBatchNorm2d(shape[1]).cuda().train().requires_grad_(False)
        forms = {"cudnn": lambda: nn.BatchNorm2d.forward(bn, x), "sync": lambda: bn(x)}
        row = []
        with torch.autocast("cuda", torch.bfloat16):
            for name, fwd in forms.items():
                both = ms_per_call(lambda: fwd().backward(g))
                with torch.no_grad():
                    alone = ms_per_call(fwd)
                totals[name][0] += both
                totals[name][1] += alone
                row.append(f"{name} {both:.3f} / {alone:.3f}")
        print(f"bn {shape}: ms forward+backward / forward alone: " + ", ".join(row), flush=True)
    print("bn sum over the shapes: " + ", ".join(
        f"{k} {a:.3f} / {b:.3f}" for k, (a, b) in totals.items()), flush=True)
    for n in (43_000_000, 2 * 2048 + 1):
        t = torch.randn(n, device="cuda")
        print(f"all_reduce of {n} f32 at world {dist.world()} ({dist.backend()}): "
              f"{ms_per_call(lambda: dist.all_reduce_sum(t)):.4f} ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("sync_bn_probe: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    dist.launch(probe, 1, "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
