#!/usr/bin/env python3
"""Time a benchmark cell's unit untraced, under the light window and under
the full trace, and print the light window's readings.

    python3 light_probe.py --workload NAME [--seed N] [--units N] [--rounds R]

From the root of a checkout, on a machine with a CUDA card.  The cell is
built as ``benchmark/run.py`` builds it (the port's step or evaluator, the
seeded weights and traffic, the set-up steps or images), without the
comparison with the reference.  Then, ``--rounds`` times in turn: an
untraced closed loop of ``--units`` steps or images (ms per unit, the
host's clock, ending in a synchronise) and the light window
(``benchmark/harness/light.py``: a profiler of CUDA activity alone, the
port's span recorder on) over the cell's ``trace_steps`` or
``trace_images``; then the full traced window (``benchmark/harness/trace.py``)
and one more light window after it.  Each round's numbers go to standard
output and to ``chiprun_out/light_probe.jsonl`` as one JSON line, with the
card's name and power limit; standard error gets the light window's
largest idle buckets by span.  The span recorder's host cost (µs of one
``span`` with no recording open and with one open, beside a bare
``record_function``) is on the first line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from benchmark import run as bench_run  # noqa: E402
from benchmark.harness import eval_cell, manifest, program, train_cell  # noqa: E402
from benchmark.harness.device import free, sync  # noqa: E402
from benchmark.harness.light import idle_line, run_light  # noqa: E402
from benchmark.harness.trace import run_traced  # noqa: E402
from benchmark.harness.weights import load_exact  # noqa: E402
from diga_tpu_torch.utils import profiling  # noqa: E402

OUT = os.path.join(ROOT, "chiprun_out", "light_probe.jsonl")


def span_host_us(n: int = 20000) -> dict:
    """Host µs of one enter and exit: a bare ``record_function``, a ``span``
    with no recording open, and one with a recording open (best of 3)."""
    def best(make):
        out = math.inf
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n):
                with make("span_cost"):
                    pass
            out = min(out, (time.perf_counter() - t0) / n * 1e6)
        return out

    us = {"record_function_us": best(torch.profiler.record_function),
          "span_off_us": best(profiling.span)}
    with profiling.recording():
        us["span_on_us"] = best(profiling.span)
    return us


def build(cell, seed: int, device):
    """(unit_fn(i), the units of the traced windows, the program's spans' root)."""
    tr = cell.traffic
    if tr["kind"] == "train":
        state, step = program.build_train(cell.config, tr, device)
        inputs = train_cell.Inputs(cell.config, tr, seed, device)
        train_cell.load_program(state, inputs)
        for i in range(tr["checked_steps"] + tr["warmup_steps"]):
            step(state, inputs.batch(i), **inputs.kwargs(i))
        sync(device)
        return (lambda i: step(state, inputs.batch(i), **inputs.kwargs(i))), \
            tr["trace_steps"], "train_step"
    evaluator, model = program.build_eval(cell.config, tr, device)
    weights, pool, _ = eval_cell.inputs(cell.config, tr, seed, device)
    load_exact(model, weights, "the program's eval model")
    for i in range(tr["warmup_images"]):
        evaluator.update(pool[i % len(pool)]["image"], pool[i % len(pool)]["label"])
    sync(device)

    def unit(i):
        item = pool[i % len(pool)]
        evaluator.update(item["image"], item["label"])
        sync(device)

    return unit, tr["trace_images"], "eval_update"


def untraced_ms(unit, n: int, device) -> float:
    sync(device)
    t0 = time.perf_counter()
    for i in range(n):
        unit(i)
    sync(device)
    return (time.perf_counter() - t0) / n * 1e3


def light_numbers(light, root: str) -> dict:
    return {"light_ms_per_unit": light.unit_ms(),
            "light_unit_span_ms": light.mean_span_ms("bench_unit"),
            "idle_share_light": light.idle_share(),
            "idle_unnamed_share": light.idle_unnamed_share(),
            "step_host_light_ms": light.mean_span_ms("train_step"),
            "eval_h2d_ms": light.span_ms_per_unit("h2d"),
            "host_syncs": light.syncs_per_unit(root),
            "syncs_by_span": light.syncs,
            "launch_share_in_units": light.launch_share_in_units(),
            "launches": light.launches, "drift_us": light.drift_us,
            "idle_ms_per_unit_by_span": {k: 1e3 * v / light.units
                                         for k, v in light.top_idle(8)}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=2_900_000_123)
    p.add_argument("--units", type=int, default=12)
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)
    bench_run.pin_caches()
    device = torch.device("cuda", 0)
    card = f"{torch.cuda.get_device_name(device)}, {bench_run.card_power_limit()}"
    cell = manifest.resolve(args.workload, manifest.load(ROOT))
    t0 = time.perf_counter()
    unit, n_traced, root = build(cell, args.seed, device)
    head = {"workload": args.workload, "card": card, "seed": args.seed,
            "setup_s": time.perf_counter() - t0, **span_host_us()}
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    lines = [head]
    i = 0

    def light_round(tag):
        nonlocal i
        base = i
        i += n_traced
        try:
            light = run_light(lambda j: unit(base + j), n_traced, device, profiling)
        except ValueError as e:  # a trace that lost its clock markers
            print(f"{args.workload} {tag}: {e}", file=sys.stderr)
            return {"light_error": str(e)}
        print(f"{args.workload} {tag}: " + idle_line(light), file=sys.stderr)
        return light_numbers(light, root)

    for r in range(args.rounds):
        row = {"workload": args.workload, "round": r,
               "untraced_ms_per_unit": untraced_ms(lambda j: unit(i + j), args.units, device)}
        i += args.units
        row.update(light_round(f"round {r}"))
        lines.append(row)
    base = i
    t = run_traced(lambda j: unit(base + j), n_traced, device)
    i += n_traced
    spans = t.program_spans_s.get(root, [])
    row = {"workload": args.workload, "round": "full",
           "full_ms_per_unit": 1e3 * t.window_s / t.units,
           "full_idle_share": 100.0 * (1 - t.busy_s / t.window_s),
           "full_root_span_ms": 1e3 * sum(spans) / len(spans) if spans else None}
    row.update({f"after_full_{k}": v for k, v in light_round("after the full trace").items()})
    lines.append(row)
    for line in lines:
        print(json.dumps(line), flush=True)
    with open(OUT, "a") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
