#!/usr/bin/env python3
"""B1a's and B1b's device time against the class count K, on the card.

    python3 distill_probe.py

Run from the root of a checkout on a machine with the card (one H100).  It
builds the kernels from the checkout (``diga_tpu_torch/ops/native.py``)
and times ``distillation_loss_kernel`` (B1a) and
``distillation_grad_kernel`` (B1b) at (8, 512, 896, K) for K = 15..20, 24
and 32 in bf16, and K = 16 and 19 in f32, as ``chip_smoke.py`` phase 9
times them (CUDA events around back-to-back calls queued behind a sleep
kernel, inputs cycled through more than the 50 MB L2), each beside its
byte bound.

Each thread of a tile walks its own pixel's row of K values in shared
memory, so the 32 lanes of a warp read addresses K elements apart.  The
script prints, per K, how many lanes of a warp fall on one 4-byte bank
with distinct words (the conflict degree of those reads: 1 is free), so
the times can be read against it.
"""

from __future__ import annotations

import math
import sys

import torch

import chip_smoke as S
from diga_tpu_torch.ops import distill as D
from diga_tpu_torch.ops import native

BATCH_HW = (8, 512, 896)
K_BF16 = (15, 16, 17, 18, 19, 20, 24, 32)
K_F32 = (16, 19)


def conflict_degree(k: int, elem: int) -> int:
    """Most distinct 4-byte words that one bank serves when the 32 lanes read
    element j of rows k elements apart (the worst j)."""
    worst = 1
    for j in range(k):
        words = {(p * k + j) * elem // 4 for p in range(32)}
        per_bank: dict[int, int] = {}
        for word in words:
            per_bank[word % 32] = per_bank.get(word % 32, 0) + 1
        worst = max(worst, max(per_bank.values()))
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("distill_probe: torch.cuda.is_available() is False; this script runs on the card",
              file=sys.stderr)
        return 1
    card = S.card_line()
    native.build()
    g = torch.tensor(0.5, device="cuda")
    for dtype, ks in ((torch.bfloat16, K_BF16), (torch.float32, K_F32)):
        elem = torch.finfo(dtype).bits // 8
        for k in ks:
            shape = (*BATCH_HW, k)
            n_buf = max(2, math.ceil(120e6 / (2 * math.prod(shape) * elem)))
            pairs = [S.distill_inputs(shape, dtype, seed=400 + i) for i in range(n_buf)]
            xb = math.prod(shape) * elem
            for name, fn, args, n_bytes in (
                    ("B1a", D.distillation_loss_kernel, [(t, s, 0.5) for t, s in pairs],
                     2 * xb + 4),
                    ("B1b", D.distillation_grad_kernel, [(t, s, g, 0.5) for t, s in pairs],
                     3 * xb + 4)):
                dev, call = S.time_us(fn, args)
                bound, by = S.bound_us(n_bytes, 8 * 2 * math.prod(shape))
                print(f"distill_probe {name} shape={shape} {str(dtype).split('.')[-1]}: device "
                      f"{dev:.2f} us (call {call:.2f}) bound {bound:.2f} us by {by} share "
                      f"{bound / dev:.2f} | smem row reads {conflict_degree(k, elem)}-way | "
                      f"card={card}", flush=True)
            del pairs
    return 0


if __name__ == "__main__":
    sys.exit(main())
