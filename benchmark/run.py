#!/usr/bin/env python3
"""Run one cell of the benchmark of diga_tpu_torch once.

    python benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout on a machine with the cell's CUDA cards.  The
cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix, found by name (``benchmark/README.md``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit, which also close standard error.  Without a
card, with fewer cards than the cell asks for, or when the process has
loaded JAX or the JAX package, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# whole top-level module names: diga_tpu_torch begins with diga_tpu but is not it
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "diga_tpu")
CACHE = os.path.join(ROOT, ".bench_cache")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def pin_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's nvcc output is ``diga_tpu_torch/_build``, inside it already)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
        os.makedirs(os.environ[var], exist_ok=True)


def card_power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell, out: dict, correct: bool, checks: dict, trace: bool, kind: str,
                power_limit: str) -> dict:
    """The last line of standard output; ``checks`` is its last key."""
    if trace:
        metrics = out["per_layer"]
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": out["memory_peak_bytes"], "power_limit": power_limit}
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dev}
    if trace:
        t = out["trace"]
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        line["breakdown"] = {"device_ops": t.top_ops, "idle_gaps": t.idle_gaps}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness import manifest
    from benchmark.harness.compare import judge

    cell = manifest.resolve(args.workload, manifest.load(ROOT))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}: no result", file=sys.stderr)
        return 2
    pin_caches()
    device = torch.device("cuda", 0)
    if cell.traffic["kind"] == "train":
        from benchmark.harness import train_cell as runner
    else:
        from benchmark.harness import eval_cell as runner
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {found}: the port must not load JAX or the "
              "JAX package; no result", file=sys.stderr)
        return 3
    ok, checks = judge(out["readings"], cell.traffic["limits"])
    correct = ok and out["failed"] == 0
    line = result_line(cell, out, correct, checks, bool(args.trace),
                       torch.cuda.get_device_name(device), card_power_limit())
    print(f"card: {line['device']['kind']}, power limit {line['device']['power_limit']}; "
          f"window {out['window_s']:.3f} s; reference {out['reference_s']:.3f} s",
          file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
