"""A traced sub-window: ``torch.profiler`` over a few steps or images, and
the reductions the per-layer metrics read.

The component attribution is a copy of the program's
``diga_tpu_torch/utils/profiling.py`` (``default_component``,
``_scopes_of``, ``_launchers``, ``attribute_events``): every device op is
charged to the scope path of the CPU op that launched it, and an op of the
backward pass to its forward op's scopes through the autograd sequence
number.  Which scopes are the model's and the optimizer's comes from the
cell (``Scopes``): the configuration file's ``program_scope`` and the
optimizer module's ``PROGRAM_SPANS``.  Busy time is the union of the
device ops' intervals, not their sum; the traced window runs from the
first of the benchmark's own spans (``bench_unit``, one around each step
or image) to the end of the last device op.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

UNIT_SPAN = "bench_unit"


@dataclasses.dataclass(frozen=True)
class Scopes:
    """The program's span names of a cell's model and optimizer."""
    model: tuple[str, ...]
    optimizer: tuple[str, ...] = ()

    @classmethod
    def of(cls, config: dict, optimizer=None) -> Scopes:
        """From the configuration file and, for a train cell, the recipe's
        optimizer module."""
        if not config.get("program_scope"):
            raise ValueError(f"configuration {config.get('name')!r} names no program_scope")
        return cls(tuple(config["program_scope"]),
                   tuple(optimizer.PROGRAM_SPANS) if optimizer is not None else ())


def default_component(p: str, backward: bool, scopes: Scopes) -> str:
    if "ImgEncoder" in p or "ImgDecoder" in p:
        return "translator_fwd"
    if any(key in p for key in scopes.model):
        return "model_bwd" if backward else "model_fwd"
    if "ema" in p or any(key in p for key in scopes.optimizer):
        return "optimizer_ema"
    if "photometric" in p or "crdomix" in p or "hsv" in p:
        return "aug_mix"
    if "distill" in p or "cross_entropy" in p or "log_softmax" in p or "resize" in p:
        return "loss_resize"
    return "misc"


_BACKWARD_SCOPE = 1  # at::RecordScope::BACKWARD_FUNCTION


def _is_node(e) -> bool:
    return e.scope == _BACKWARD_SCOPE or e.name.startswith("autograd::engine::evaluate_function")


def _is_annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False))


def _scopes_of(cpu_events) -> dict:
    def chain(e):
        out = []
        while e is not None:
            out.append(e)
            e = e.cpu_parent
        return out

    def scopes(ch):
        return "/".join(a.name for a in reversed(ch) if _is_annotation(a))

    chains = {id(e): chain(e) for e in cpu_events}
    latest = {}
    for e in cpu_events:
        if e.sequence_nr >= 0 and not any(_is_node(a) for a in chains[id(e)]):
            key = (e.sequence_nr, e.thread)
            if key not in latest or e.time_range.start >= latest[key].time_range.start:
                latest[key] = e
    forward = {key: scopes(chains[id(e)]) for key, e in latest.items()}
    where = {}
    for e in cpu_events:
        ch = chains[id(e)]
        node = next((a for a in ch if _is_node(a)), None)
        if node is None:
            path = scopes(ch)
            where[id(e)] = (path, False) if path else None
        else:
            path = forward.get((node.sequence_nr, node.fwd_thread))
            where[id(e)] = (path, True) if path else None
    return where


def _is_runtime(e) -> bool:
    return e.name.startswith("cu") and "::" not in e.name


def _innermost(ops_sorted, starts, t):
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        if ops_sorted[i].time_range.end >= t:
            return ops_sorted[i]
    return None


@dataclasses.dataclass
class Trace:
    units: int                    # steps or images traced
    window_s: float               # first unit span's start to the last device op's end
    busy_s: float                 # union of device-op intervals inside the window
    device_ops: list              # (name, start_us, end_us)
    components: dict              # component -> device seconds per unit
    program_spans_s: dict         # name -> host seconds of the program's spans, per occurrence
    top_ops: list                 # [name, seconds] by total device time, top 10
    idle_gaps: list               # [what the host ran, seconds] by total, top 10


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def run_traced(unit_fn, n: int, device: torch.device, scopes: Scopes) -> Trace:
    """``unit_fn(i)`` for i < n under the profiler, each in a ``bench_unit`` span."""
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            with record_function(UNIT_SPAN):
                unit_fn(i)
        torch.cuda.synchronize(device)
    return reduce_events(prof.events(), n, scopes)


def reduce_events(events, n: int, scopes: Scopes) -> Trace:
    """The ``Trace`` of the profiler's events of ``n`` units."""
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU and not e.is_async]
    dev = [e for e in events if e.device_type == DeviceType.CUDA and not _is_annotation(e)]
    annotations = [e for e in cpu if _is_annotation(e)]
    units = [e for e in annotations if e.name == UNIT_SPAN]
    spans = defaultdict(list)
    for e in annotations:
        spans[e.name].append((e.time_range.end - e.time_range.start) / 1e6)
    if not units or not dev:
        return Trace(n, 0.0, 0.0, [], {}, dict(spans), [], [])
    start = min(e.time_range.start for e in units)
    end = max(max(e.time_range.end for e in dev), max(e.time_range.end for e in units))
    merged = _union([(max(e.time_range.start, start), min(e.time_range.end, end)) for e in dev
                     if e.time_range.end > start])
    busy = sum(e - s for s, e in merged) / 1e6

    # attribution of device time to the components
    where = _scopes_of(cpu)
    launch_at = {e.id: e.time_range.start for e in cpu if _is_runtime(e)}
    ops = sorted((e for e in cpu if not _is_runtime(e)), key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in ops]
    comp = defaultdict(float)
    by_name = defaultdict(float)
    for d in dev:
        sec = (d.time_range.end - d.time_range.start) / 1e6
        by_name[d.name] += sec
        t = launch_at.get(d.id)
        launcher = None if t is None else _innermost(ops, starts, t)
        joined = None if launcher is None else where.get(id(launcher))
        comp["unmatched" if joined is None else default_component(*joined, scopes)] += sec

    # idle gaps, named by the innermost host op running when each began
    gaps = defaultdict(float)
    edges = [(start, start)] + [tuple(m) for m in merged] + [(end, end)]
    for (_, prev_end), (nxt_start, _) in zip(edges, edges[1:]):
        if nxt_start > prev_end:
            op = _innermost(ops, starts, prev_end)
            gaps[op.name if op is not None else "(no host op)"] += (nxt_start - prev_end) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Trace(units=n, window_s=(end - start) / 1e6, busy_s=busy,
                 device_ops=[(d.name, d.time_range.start, d.time_range.end) for d in dev],
                 components={k: v / n for k, v in comp.items()},
                 program_spans_s=dict(spans),
                 top_ops=[[k, v] for k, v in top],
                 idle_gaps=[[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]])
