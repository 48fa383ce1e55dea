"""Per-layer metrics: one reader per metric, found by name.

``benchmark/metrics/<name>.py`` defines ``read(ctx) -> float | None``; a
reader that finds nothing to read returns None and the metric is left out
of the result line.  ``ctx`` is a ``Context``: the traced sub-window, the
untraced window's rate, the work a unit needs, the peaks, and the calls of
the program's own kernels a unit makes (shapes from the benchmark's
architectures, checked against the launches the trace shows).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import re

from .counts import distill_least_s, group_norm_least_s
from .manifest import METRICS_DIR
from .peaks import Peaks
from .trace import Trace

# the kernel families of the program's csrc/, and the kernel launched once a call
KERNELS = {
    "distill": (re.compile(r"(?<![A-Za-z0-9])distill_\w+"), "distill_grad_kernel",
                distill_least_s),
    "gn": (re.compile(r"(?<![A-Za-z0-9])gn_\w+"), "gn_stats_kernel", group_norm_least_s),
}


@dataclasses.dataclass
class Context:
    trace: Trace
    units_per_s: float            # steps or images a second, the untraced window
    unit_flops: int               # FLOPs a step or an image needs
    peaks: Peaks
    kernel_sites: dict            # family -> the NHWC shapes of one unit's calls
    elem_bytes: int               # the compute dtype's bytes


def elem_bytes(config: dict) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[config["compute_dtype"]]


def kernel_roofline(ctx: Context, family: str) -> float | None:
    """Least time of the unit's calls over the family's profiled device time, in %.

    None where the family did not run, or ran another number of calls than
    the benchmark counts (then the shapes are not known)."""
    pattern, anchor, least_fn = KERNELS[family]
    ops = [(n, s, e) for n, s, e in ctx.trace.device_ops if pattern.search(n)]
    sites = ctx.kernel_sites.get(family, [])
    calls = sum(1 for n, _, _ in ops if anchor in n)
    if not ops or not sites or calls != len(sites) * ctx.trace.units:
        return None
    busy = sum(e - s for _, s, e in ops) / 1e6
    least = ctx.trace.units * sum(least_fn(shape, ctx.elem_bytes, ctx.peaks) for shape in sites)
    return 100.0 * least / busy


def idle_share(ctx: Context) -> float | None:
    if ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def mfu(ctx: Context) -> float | None:
    if ctx.units_per_s <= 0:
        return None
    return 100.0 * ctx.unit_flops * ctx.units_per_s / ctx.peaks.bf16_flops_per_s


def component_ms(ctx: Context, names) -> float | None:
    have = [ctx.trace.components[n] for n in names if n in ctx.trace.components]
    return 1e3 * sum(have) if have else None


def load_reader(name: str):
    path = os.path.join(METRICS_DIR, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no reader for per-layer metric {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_all(metrics: list, ctx: Context) -> dict:
    out = {}
    for m in metrics:
        value = load_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
