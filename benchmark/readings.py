#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from (not run by the benchmark).

    python benchmark/readings.py --workload NAME --seeds 1,2,... \
        [--control 1,2,3] [--half_batch 1,2,3] [--out FILE]

On a CUDA card, at the cell's own sizes, for each seed: the program's
numbers (the timed path's first checked steps, or its predictions of the
first ``sample_images`` pool images) against the f32 reference; for the
``--control`` seeds, the reference computed in the precision below the
configuration's (fp8, ``reference/lowp.py``) put in the program's place;
for the ``--half_batch`` seeds (train cells), the program with half of
every batch left out.  One JSON line a reading, to standard output and to
``--out``.  ``PERF.md`` keeps the readings and the limits set from them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ints(text: str) -> list[int]:
    return [int(x) for x in text.split(",") if x]


def train_readings(cell, seed: int, control: bool, half: bool, device) -> list[dict]:
    from benchmark.harness import compare, program, train_cell
    from benchmark.harness.device import free
    from benchmark.harness.faults import HalfBatch

    tr, n = cell.traffic, cell.traffic["checked_steps"]
    inputs = train_cell.Inputs(cell.config, tr, seed, device)
    runs = [("sound", inputs)] + ([("half_batch", HalfBatch(inputs))] if half else [])
    progs = {}
    for kind, feed in runs:
        state, step = program.build_train(cell.config, tr, device)
        train_cell.load_program(state, inputs)
        progs[kind] = train_cell.first_steps(state, step, feed, n)
        del state, step
        free(device)
    ref = train_cell.reference_readings(cell.config, inputs, n, device)
    out = [{"kind": k, **compare.train_readings(p, ref)} for k, p in progs.items()]
    out[0]["worst"] = {f: compare.worst_leaves(progs["sound"], ref, f)
                       for f in ("first_update", "change", "stats_change")}
    out[0]["median_leaf_gap"] = {f: median_gap(progs["sound"], ref, f)
                                 for f in ("first_update", "change")}
    if control:
        low = train_cell.reference_readings(cell.config, inputs, n, device, precision="fp8")
        out.append({"kind": "control", **compare.train_readings(low, ref)})
    out[0]["loss"], out[0]["ref_loss"] = progs["sound"]["loss"], ref["loss"]
    return out


def median_gap(prog: dict, ref: dict, field: str) -> float:
    import statistics

    from benchmark.harness import compare

    keys = compare.moving_leaves(ref)
    return statistics.median(abs(prog[field].get(n, 0.0) - ref[field][n]) / ref[field][n]
                             for n in keys)


def eval_readings(cell, seed: int, control: bool, device) -> list[dict]:
    import torch

    from benchmark.harness import eval_cell, program
    from benchmark.harness.device import free
    from benchmark.harness.weights import load_exact
    from benchmark.reference.evaluate import two_scale_logits

    tr = cell.traffic
    evaluator, model = program.build_eval(cell.config, tr, device)
    weights, pool, _ = eval_cell.inputs(cell.config, tr, seed, device)
    load_exact(model, weights, "the program's eval model")
    images = list(range(min(tr["sample_images"], len(pool))))
    preds = [evaluator.update(pool[i]["image"], pool[i]["label"]).to(torch.uint8) for i in images]
    del evaluator, model
    free(device)
    ref = eval_cell.reference_model(cell.config, weights, device)
    out = [{"kind": "sound", "logit_gap": max(eval_cell.gaps(ref, tr, pool, images, preds,
                                                             device))}]
    if control:
        low = [two_scale_logits(ref, torch.from_numpy(pool[i]["image"]).to(device), tr["out_hw"],
                                tr["ds_hw"], "fp8", tr["rgb_input"]).argmax(-1) for i in images]
        out.append({"kind": "control",
                    "logit_gap": max(eval_cell.gaps(ref, tr, pool, images, low, device))})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=ints, required=True)
    p.add_argument("--control", type=ints, default=[])
    p.add_argument("--half_batch", type=ints, default=[])
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import manifest

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    cell = manifest.resolve(args.workload, manifest.load(ROOT))
    device = torch.device("cuda", 0)
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            if cell.traffic["kind"] == "train":
                rows = train_readings(cell, seed, seed in args.control, seed in args.half_batch,
                                      device)
            else:
                rows = eval_readings(cell, seed, seed in args.control, device)
            for row in rows:
                line = json.dumps({"workload": args.workload, "seed": seed, **row,
                                   "seconds": time.perf_counter() - t0})
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
