"""The attention calls of a train step, and their least time on the card.

The calls are counted on the reference's architecture (``benchmark/
reference``), never on the program's modules: the family's model runs on
the ``meta`` device at the cell's shapes, and a hook on each attention's
query and key/value projections reads its batch B, heads h, queries N,
keys M and head size d.  A train step calls attention in the teacher's
forward and the student's forward and backward on [source; view] (batch
2 x source), and in the target-stats forward (the target batch).

A call's least time is the work the algorithm needs, whatever implements
it, at the card's peaks: forward 4·B·h·N·M·d FLOPs (two products) and Q,
K, V and O moved once; backward 8·B·h·N·M·d FLOPs (dQ, dK, dV and dP)
and Q, K, V, O, dO, dQ, dK and dV moved once; each at ``elem`` bytes an
element (bf16: 2), the longer of the two times.
"""

from __future__ import annotations

import json
import os
import re

import torch

from ..reference import build_model
from .peaks import Peaks

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def read_cell_files(config_name: str, traffic_name: str) -> tuple[dict, dict]:
    """A cell's configuration and traffic files, by path."""
    with open(os.path.join(HERE, "configs", f"{config_name}.json")) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", f"{traffic_name}.json")) as f:
        traffic = json.load(f)
    return config, traffic


def forward_calls(config: dict, b: int, hw, stats: bool = False) -> list[tuple]:
    """(B, h, N, M, d) of every attention call of one forward (or of the
    target-stats forward) at batch ``b`` and size ``hw``."""
    with torch.device("meta"):
        model = build_model(config).eval()
    calls, hooks = [], []
    for m in model.modules():
        if hasattr(m, "num_heads") and hasattr(m, "kv"):
            seen = {}
            hooks.append(m.q.register_forward_hook(
                lambda mod, i, o, seen=seen: seen.update(q=tuple(i[0].shape))))
            hooks.append(m.kv.register_forward_hook(
                lambda mod, i, o, seen=seen, h=m.num_heads: calls.append(
                    (seen["q"][0], h, seen["q"][1], i[0].shape[1], seen["q"][2] // h))))
    x = torch.empty((b, 3, *hw), device="meta")
    with torch.no_grad():
        model.stats_forward(x) if stats else model(x)
    for h in hooks:
        h.remove()
    return calls


def step_calls(config: dict, traffic: dict) -> dict[str, list[tuple]]:
    """{"forward": [...], "backward": [...]}: one train step's calls."""
    hw, b = traffic["crop_hw"], traffic["source_batch"]
    fwd = forward_calls(config, 2 * b, hw)
    out = {"forward": fwd + fwd, "backward": list(fwd)}
    if traffic["recipe"]["tgt_stats_forward"]:
        out["forward"] += forward_calls(config, traffic["target_batch"], hw, stats=True)
    return out


def least_s(call: tuple, backward: bool, elem: int, peaks: Peaks) -> float:
    b, h, n, m, d = call
    flops = (8 if backward else 4) * b * h * n * m * d
    per_side = 4 if backward else 2  # (Q, O[, dO, dQ]) of N rows, (K, V[, dK, dV]) of M
    moved = elem * per_side * b * h * d * (n + m)
    return max(flops / peaks.bf16_flops_per_s, moved / peaks.hbm_bytes_per_s)


# The flash-attention kernels F.scaled_dot_product_attention launches on
# the H100 (torch 2.11, cu128; read from the cell's trace): a forward call
# is one ``pytorch_flash::flash_fwd_kernel``, a backward call
# ``flash_bwd_dot_do_o_kernel``, ``flash_bwd_dq_dk_dv_loop_seqk_parallel_
# kernel`` and ``flash_bwd_convert_dq_kernel``.  The anchors are the kernel
# each call launches once.  Where PyTorch picks another backend (the
# memory-efficient one) nothing matches and the metrics are silent.
KERNELS = re.compile(r"pytorch_flash::flash_(fwd|bwd)_")
ANCHORS = {"forward": re.compile(r"pytorch_flash::flash_fwd_kernel<"),
           "backward": re.compile(r"pytorch_flash::flash_bwd_dq_dk_dv_loop")}


def device_s(trace) -> float | None:
    """Device seconds of the traced window's attention kernels, or None."""
    ops = [(s, e) for n, s, e in trace.device_ops if KERNELS.search(n)]
    return sum(e - s for s, e in ops) / 1e6 if ops else None


def roofline(trace, calls: dict, elem: int, peaks: Peaks) -> float | None:
    """The calls' least time over the kernels' device time, in %; None where
    the trace shows another number of forward or backward calls."""
    busy = device_s(trace)
    if busy is None:
        return None
    for kind, pattern in ANCHORS.items():
        launched = sum(1 for n, _, _ in trace.device_ops if pattern.search(n))
        if launched != len(calls[kind]) * trace.units:
            return None
    least = sum(least_s(c, kind == "backward", elem, peaks)
                for kind, cs in calls.items() for c in cs)
    return 100.0 * trace.units * least / busy
