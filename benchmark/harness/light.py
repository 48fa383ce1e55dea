"""A light traced sub-window: ``torch.profiler`` with CUDA activity alone
(kernels, copies, memsets and the CUDA runtime's calls; no aten op is
recorded, and no external correlation is pushed around each op), and the
program's own spans, recorded on the host's clock and moved onto the
trace's timeline.

``run_light(unit_fn, n, device, recorder)`` runs ``unit_fn(i)`` for i < n,
each in a recorder span ``bench_unit``.  ``recorder`` is the program's span
recorder (``diga_tpu_torch/utils/profiling.py``: ``start_recording``,
``stop_recording``, ``span``, ``mark_clock``), handed in by the caller so
that ``harness/program.py`` stays the one module that imports the port.
A clock marker before the first unit and one after the last device op
give the offset of the host's clock to the trace's, read from the marker
kernel's launch call (a frozen copy of the program's ``clock_offsets``,
launch branch): the window's first and last kernel launches, since a
profiler session can lose the device records of its first kernels (seen
on an H100), never their launch calls.  Both are left out of every
reduction.

The reductions (``reduce_light``) take plain tuples, so they are tested on
synthetic lists.  The window is the traced window's rule
(``harness/trace.py``): from the first unit's start to the last device
op's end, busy time the union of the device ops' intervals.  Each instant
of idle time is charged to the innermost program span open then (the one
that started last), ``(outside any span)`` where none is: ``bench_unit``
is the benchmark's span, not the program's.  The synchronising runtime
calls are charged the same way, by their start.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict

import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from .trace import UNIT_SPAN, _is_annotation, _is_runtime, _union

OUTSIDE = "(outside any span)"
MARK_KERNEL = re.compile(r"spin_kernel")  # torch.cuda._sleep's, the program's marker
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})


def _is_launch(name: str) -> bool:
    return name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))


@dataclasses.dataclass
class Light:
    units: int
    window_s: float               # first unit's start to the last device op's end
    busy_s: float                 # union of device-op intervals inside the window
    device_ops: list              # (name, start_us, end_us), the markers left out
    spans: list                   # (name, parent, start_us, end_us, thread) on the trace
    idle_by_span: dict            # innermost program span -> idle seconds
    syncs: dict                   # innermost program span -> synchronising calls
    sync_calls: list              # (name, start_us) of each synchronising call
    launches: int                 # kernel launch calls, the markers left out
    launches_in_units: int        # of which inside a bench_unit span
    drift_us: float               # the clock offset's change between the markers

    def idle_share(self) -> float | None:
        """1 - busy over the window, %."""
        if self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def idle_unnamed_share(self) -> float | None:
        """Idle time in no program span over all idle time, %."""
        idle = sum(self.idle_by_span.values())
        if idle <= 0:
            return None
        return 100.0 * self.idle_by_span.get(OUTSIDE, 0.0) / idle

    def mean_span_ms(self, name: str) -> float | None:
        """Mean host ms of the program's spans ``name``."""
        ms = [e - s for n, _, s, e, _ in self.spans if n == name]
        return sum(ms) / len(ms) / 1e3 if ms else None

    def span_ms_per_unit(self, name: str) -> float | None:
        """Host ms of the program's spans ``name``, summed, per unit."""
        ms = [e - s for n, _, s, e, _ in self.spans if n == name]
        return sum(ms) / 1e3 / self.units if ms else None

    def syncs_per_unit(self, root: str) -> float | None:
        """Synchronising calls inside the program's spans ``root``, per unit;
        None where no span ``root`` was recorded."""
        roots = [(s, e) for n, _, s, e, _ in self.spans if n == root]
        if not roots:
            return None
        inside = sum(1 for _, t in self.sync_calls if any(s <= t <= e for s, e in roots))
        return inside / self.units

    def unit_ms(self) -> float | None:
        """The window's wall ms per unit."""
        return 1e3 * self.window_s / self.units if self.window_s > 0 else None

    def launch_share_in_units(self) -> float | None:
        """Kernel launch calls inside a ``bench_unit`` span, %: near 100 where
        the host's clock is moved onto the trace's right."""
        return 100.0 * self.launches_in_units / self.launches if self.launches else None

    def top_idle(self, k: int = 5) -> list:
        return sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:k]


def clock_offsets(launches: list, marks: list) -> list[tuple[float, float]]:
    """(start, end) offsets, trace µs minus host µs, of each clock marker:
    its kernel's launch call ``(start_us, end_us)`` against the host reads
    ``(t0, t1, t2, t3)`` (ns), the launch between ``t1`` and ``t2``."""
    if len(launches) != len(marks):
        raise ValueError(f"the trace holds {len(launches)} clock marker launches, "
                         f"the recording {len(marks)}")
    return [(s - t1 / 1e3, e - t2 / 1e3) for (s, e), (_, t1, t2, _) in zip(launches, marks)]


def on_trace(spans: list, marks: list, offsets: list) -> tuple[list, float]:
    """Recorded spans (ns) on the trace's timeline (µs), each offset moved
    linearly from the first marker's to the last one's; and the drift."""
    (s0, e0), (s1, e1) = offsets[0], offsets[-1]
    h0, h1 = marks[0][0] / 1e3, marks[-1][0] / 1e3
    width = h1 - h0 if h1 > h0 else float("inf")

    def at(ns, first, last):
        us = ns / 1e3
        return us + first + (last - first) * (us - h0) / width

    return ([(n, p, at(s, s0, s1), at(e, e0, e1), t) for n, p, s, e, t in spans],
            (s1 + e1 - s0 - e0) / 2)


def _innermost(spans_by_start: list, starts: list, t: float) -> str:
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        name, s, e = spans_by_start[i]
        if e > t:
            return name
    return OUTSIDE


def split_by_innermost(intervals: list, spans: list) -> dict:
    """Seconds of ``intervals`` ((start_us, end_us), disjoint) under the
    innermost of ``spans`` ((name, start_us, end_us)) open at each instant."""
    order = sorted(spans, key=lambda x: x[1])
    starts = [s for _, s, _ in order]
    bounds = sorted({s for _, s, _ in spans} | {e for _, _, e in spans})
    out = defaultdict(float)
    for a, b in intervals:
        cuts = [a] + bounds[bisect.bisect_right(bounds, a):bisect.bisect_left(bounds, b)] + [b]
        for x, y in zip(cuts, cuts[1:]):
            if y > x:
                out[_innermost(order, starts, (x + y) / 2)] += (y - x) / 1e6
    return dict(out)


def _marker_ids(device_ops: list, kernel_launches: list, n_marks: int) -> set:
    """Correlation ids of the clock markers' launches: the window's first and
    last kernel launches (nothing else launches before the first marker or
    after the last), each checked against its kernel's name where the trace
    kept the kernel; a session can lose the device records of its first
    kernels, never their launch calls."""
    if n_marks != 2 or len(kernel_launches) < 2:
        raise ValueError(f"the trace holds {len(kernel_launches)} kernel launches, the "
                         f"recording {n_marks} clock markers: expected 2 markers")
    ids = {kernel_launches[0][2], kernel_launches[-1][2]}
    names = {i: name for name, _, _, i in device_ops}
    wrong = [names[i] for i in ids if i in names and not MARK_KERNEL.search(names[i])]
    if wrong:
        raise ValueError(f"the window's first or last kernel launch is not a clock marker: "
                         f"{wrong}")
    return ids


def reduce_light(device_ops: list, runtime: list, spans: list, marks: list, n: int) -> Light:
    """The light window's reductions.

    ``device_ops``: (name, start_us, end_us, correlation id) of the kernels,
    copies and memsets; ``runtime``: (name, start_us, end_us, correlation
    id) of the CUDA runtime's calls; ``spans``: the recorder's (name,
    parent, start_ns, end_ns, thread); ``marks``: its clock markers' reads,
    the first before the first unit, the last after the last device op."""
    kernel_launches = sorted((s, e, i) for name, s, e, i in runtime if _is_launch(name))
    marker_ids = _marker_ids(device_ops, kernel_launches, len(marks))
    launches = [(s, e) for s, e, i in kernel_launches if i in marker_ids]
    traced, drift = on_trace(spans, marks, clock_offsets(launches, marks))
    ops = [(name, s, e) for name, s, e, i in device_ops if i not in marker_ids]
    units = [(s, e) for name, _, s, e, _ in traced if name == UNIT_SPAN]
    program = [(name, s, e) for name, _, s, e, _ in traced if name != UNIT_SPAN]
    calls = [(name, s) for name, s, _, i in runtime if i not in marker_ids]
    sync_calls = [(name, s) for name, s in calls if name in SYNC_CALLS]
    syncs = defaultdict(int)
    order = sorted(program, key=lambda x: x[1])
    starts = [s for _, s, _ in order]
    for _, t in sync_calls:
        syncs[_innermost(order, starts, t)] += 1
    kernel_calls = [t for name, t in calls if _is_launch(name)]
    in_units = sum(1 for t in kernel_calls if any(s <= t <= e for s, e in units))
    if not units or not ops:
        return Light(n, 0.0, 0.0, ops, traced, {}, dict(syncs), sync_calls,
                     len(kernel_calls), in_units, drift)
    start = min(s for s, _ in units)
    end = max(max(e for _, _, e in ops), max(e for _, e in units))
    merged = _union([(max(s, start), min(e, end)) for _, s, e in ops if e > start])
    busy = sum(e - s for s, e in merged) / 1e6
    edges = [(start, start)] + [tuple(m) for m in merged] + [(end, end)]
    idle = [(prev_end, nxt_start) for (_, prev_end), (nxt_start, _) in zip(edges, edges[1:])
            if nxt_start > prev_end]
    return Light(units=n, window_s=(end - start) / 1e6, busy_s=busy, device_ops=ops,
                 spans=traced, idle_by_span=split_by_innermost(idle, program),
                 syncs=dict(syncs), sync_calls=sync_calls, launches=len(kernel_calls),
                 launches_in_units=in_units, drift_us=drift)


def _light_profile():
    # no external correlation: no aten op is recorded to be joined to its
    # kernels, and pushing a correlation id around each op cost a step of
    # ~11,000 launches 25 % more host time (H100)
    return profile(activities=[ProfilerActivity.CUDA],
                   experimental_config=_ExperimentalConfig(disable_external_correlation=True))


def run_light(unit_fn, n: int, device: torch.device, recorder) -> Light:
    """``unit_fn(i)`` for i < n under a profiler of CUDA activity alone, each
    in a recorder span ``bench_unit``, the program's recorder on."""
    from torch.autograd import DeviceType

    # a first session in a process paid 10 % more host time on an H100: a
    # throwaway one, around a marker with no recording open (kept nowhere),
    # which also loads the marker's kernel
    with _light_profile():
        recorder.mark_clock(device)
        torch.cuda.synchronize(device)
    rec = recorder.start_recording()
    try:
        with _light_profile() as prof:
            recorder.mark_clock(device)
            torch.cuda.synchronize(device)
            for i in range(n):
                with recorder.span(UNIT_SPAN):
                    unit_fn(i)
            torch.cuda.synchronize(device)
            recorder.mark_clock(device)
            torch.cuda.synchronize(device)
    finally:
        recorder.stop_recording(rec)
    events = prof.events()
    device_ops = [(e.name, e.time_range.start, e.time_range.end, e.id) for e in events
                  if e.device_type == DeviceType.CUDA and not _is_annotation(e)]
    runtime = [(e.name, e.time_range.start, e.time_range.end, e.id) for e in events
               if e.device_type == DeviceType.CPU and _is_runtime(e)]
    return reduce_light(device_ops, runtime, rec.spans, rec.marks, n)


def idle_line(light: Light, k: int = 5) -> str:
    """One line: the light window's ``k`` largest idle buckets by span."""
    parts = ", ".join(f"{name} {1e3 * sec / light.units:.3f}" for name, sec in
                      light.top_idle(k))
    return (f"light window: idle {light.idle_share() or 0.0:.2f} % over {light.units} units; "
            f"largest idle ms per unit by span: {parts}")
