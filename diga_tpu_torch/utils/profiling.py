"""Device-time breakdown of a train step from a ``torch.profiler`` trace.

Counterpart of ``diga_tpu/utils/profiling.py`` (:1-160) on
``torch.profiler``: ``profile_step`` runs a step a few times to warm up,
times it without the profiler (the unprofiled ms/step), then traces
``n_steps`` more with CPU and CUDA activities; ``ProfileReport`` sums the
device kernels and copies by family (``op_category``) and by name, per
step, and gives the busy share (device time over the unprofiled step
time).

Component attribution (JAX :183-252): the train steps wrap each of their
parts in a ``torch.profiler.record_function`` scope (``train/steps.py``,
``train/steps_translator.py``), named so that ``default_component``, the
JAX package's rule, reads the scope path as it reads a jax op path.
``attribute_events`` charges every device op (a kernel, copy or memset;
on the CPU, every CPU op's self time) to the scope path of the CPU op
that launched it; an op launched by the backward pass takes its forward
op's scopes, joined through the autograd sequence number, as
``backward``.  What cannot be joined is ``unmatched``, as in JAX's
``attribute_trace``.  The JAX module's xplane and HLO parsing has no
counterpart: there is no XLA program here.

Spans (``span``) are the port's one scope helper: every scope of the
steps, the evaluator and the loop is a ``span``, which always enters
``record_function`` (what the attribution above reads) and, while a
recording is open (``recording()``, or ``start_recording`` /
``stop_recording``), also keeps ``(name, parent, start_ns, end_ns,
thread)`` on ``time.perf_counter_ns``; ``count(name, n)`` adds to a
tally.  Nothing touches the device or synchronises, and with no recording
open a span costs one check beyond ``record_function``.  Recordings may
nest: each keeps every span from its start, and is drained and stopped on
its own.  ``mark_clock`` puts a marker the trace records (one tiny kernel
launch on the card, a ``record_function`` on the CPU) between host clock
reads; ``spans_on_trace`` maps the recorded spans onto a trace's timeline
by the offsets the first and last markers measure, and reports the drift
between them: the profiler's clock is not assumed to be
``perf_counter_ns``.
"""

from __future__ import annotations

import bisect
import contextlib
import math
import os
import re
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable

import torch
from torch.profiler import record_function

# the port's own kernels (csrc/distill.cu: B1a/B1b; csrc/group_norm.cu: B2a/B2b)
PORT_KERNELS = {"distill": re.compile(r"(?<![A-Za-z0-9])distill_\w+"),
                "group_norm": re.compile(r"(?<![A-Za-z0-9])gn_\w+")}
# each port kernel's launches by the name of its device record, under the
# tallies' names (ops/distill.py, ops/group_norm.py); a B1a launch runs
# distill_partial_kernel, then distill_fold_kernel
PORT_LAUNCHES = {
    "distill_loss": re.compile(r"(?<![A-Za-z0-9_])distill_partial_kernel(?!\w)"),
    "distill_grad": re.compile(r"(?<![A-Za-z0-9_])distill_grad_kernel(?!\w)"),
    "group_norm_stats": re.compile(r"(?<![A-Za-z0-9_])gn_stats_kernel(?!\w)"),
    "group_norm_apply": re.compile(r"(?<![A-Za-z0-9_])gn_apply_kernel(?!\w)"),
}
# (family, pattern) in the order they are tried: the first match wins
_FAMILIES = [
    ("copy", re.compile(r"memcpy|memset|copy|convert|nchwtonhwc|nhwctonchw|transpose")),
    ("batch_norm", re.compile(r"batch_norm|bn_fw|bn_bw|\bbn_|welford")),
    ("convolution", re.compile(r"conv|fprop|dgrad|wgrad|implicit_gemm|winograd|fft")),
    ("gemm", re.compile(r"gemm|gemv|matmul|cublas|cutlass|\baten::(mm|bmm|addmm)\b")),
    ("reduce", re.compile(r"reduce|softmax|argmax|bincount|sum_kernel|mean|norm_kernel")),
    ("resize", re.compile(r"upsample|interpolate|grid_sample")),
    ("elementwise", re.compile(r"elementwise|pointwise|where|fill|index|cat|gather|scatter"
                               r"|aten::(add|mul|sub|div|relu|clamp|exp|log)")),
]


def op_category(name: str) -> str:
    """The family of a device op's name (a CUDA kernel or copy)."""
    for family, pattern in PORT_KERNELS.items():
        if pattern.search(name):
            return family
    n = name.lower()
    for family, pattern in _FAMILIES:
        if pattern.search(n):
            return family
    return "other"


@dataclass
class ProfileReport:
    """Device-op times of one trace (seconds over the whole capture)."""

    total_s: float = 0.0
    by_category: dict = field(default_factory=dict)  # family -> (sec, count)
    top_ops: list = field(default_factory=list)  # [(sec, count, name)], largest first
    n_steps: int = 1
    step_ms: float | None = None  # the unprofiled ms/step, where measured
    components: dict | None = None  # attribute_events' split, where asked for

    @property
    def device_ms_per_step(self) -> float:
        return self.total_s / max(self.n_steps, 1) * 1e3

    @property
    def busy_share(self) -> float | None:
        return None if not self.step_ms else self.device_ms_per_step / self.step_ms

    def render(self, top_k: int = 25) -> str:
        n = max(self.n_steps, 1)
        head = f"device op time: {self.device_ms_per_step:.2f} ms/step (over {n} steps)"
        if self.step_ms:
            head += (f"; unprofiled {self.step_ms:.2f} ms/step; busy share "
                     f"{self.busy_share:.3f}")
        lines = [head, f"{'category':14s} {'ms/step':>9s} {'count/step':>11s}"]
        for c, (t, cnt) in sorted(self.by_category.items(), key=lambda kv: -kv[1][0]):
            lines.append(f"{c:14s} {t / n * 1e3:9.3f} {cnt / n:11.1f}")
        port = [op for op in self.top_ops if op_category(op[2]) in PORT_KERNELS]
        lines.append("port kernels (us/step):")
        lines += [f"{t / n * 1e6:9.2f}  x{cnt / n:<7.1f} {name[:100]}" for t, cnt, name in port]
        if not port:
            lines.append("  none in this trace")
        lines.append(f"top {top_k} device ops (ms/step):")
        lines += [f"{t / n * 1e3:9.3f}  x{cnt / n:<7.1f} {name[:100]}"
                  for t, cnt, name in self.top_ops[:top_k]]
        return "\n".join(lines)


def report_from_events(events, n_steps: int = 1, step_ms: float | None = None
                       ) -> ProfileReport:
    """Aggregate the device-side entries of a ``key_averages()``: kernels,
    copies and memsets on the card, by their own (self) time."""
    from torch.autograd import DeviceType

    rep = ProfileReport(n_steps=n_steps, step_ms=step_ms)
    cat = defaultdict(lambda: [0.0, 0])
    ops = {}
    for e in events:
        # the device-side spans of the steps' record_function scopes are not ops
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:  # torch versions before the device-generic name
            us = e.self_cuda_time_total
        sec = us / 1e6
        rep.total_s += sec
        c = cat[op_category(e.key)]
        c[0] += sec
        c[1] += e.count
        ops[e.key] = (sec, e.count, e.key)
    rep.by_category = {k: (v[0], v[1]) for k, v in cat.items()}
    rep.top_ops = sorted(ops.values(), reverse=True)
    return rep


def port_launches(top_ops) -> dict:
    """Launches of each port kernel, by its tally's name, among a report's
    ``top_ops``: what the card ran, the kernels of a CUDA graph's replays
    included (CUPTI records each by name), where the wrappers' tallies
    count a captured call once, at its capture."""
    counts = dict.fromkeys(PORT_LAUNCHES, 0)
    for _, n, name in top_ops:
        for k, pattern in PORT_LAUNCHES.items():
            if pattern.search(name):
                counts[k] += n
    return counts


@contextlib.contextmanager
def device_launches():
    """A dict that, on leaving the block, holds ``port_launches`` of the
    kernels the card ran inside it (a profiler of CUDA activity alone)."""
    from torch.profiler import ProfilerActivity, profile

    counts = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield counts
        torch.cuda.synchronize()
    counts.update(port_launches(report_from_events(prof.key_averages()).top_ops))


def default_component(scope_path: str, backward: bool) -> str:
    """Coarse component of an op from its scope path (the scopes outermost
    first, joined by "/"), by the JAX package's rule and order
    (``diga_tpu/utils/profiling.py:183-201``); ``backward`` takes the place
    of JAX's ``"transpose(" in path``.  The port's MiT-B5 (``MiTDAFormer``)
    and its ``adamw`` span, which JAX does not have, join the model and the
    optimizer."""
    p = scope_path
    if "ImgEncoder" in p or "ImgDecoder" in p:
        return "translator_fwd"  # as in JAX, the translator's backward too
    if "DeepLabV2" in p or "HRNet" in p or "MiTDAFormer" in p:
        return "model_bwd" if backward else "model_fwd"
    for key in ("sgd", "adamw", "ema", "add_decayed", "trace_update", "apply_updates",
                "scale_by", "masked", "/update/"):
        if key in p:
            return "optimizer_ema"
    if "photometric" in p or "crdomix" in p or "hsv" in p:
        return "aug_mix"
    if ("distill" in p or "cross_entropy" in p or "log_softmax" in p
            or "resize" in p):
        return "loss_resize"
    return "misc"


_BACKWARD_SCOPE = 1  # at::RecordScope::BACKWARD_FUNCTION, an autograd node's evaluation


def _is_node(e) -> bool:
    """An autograd node's evaluation: the engine's span or the node's own."""
    return e.scope == _BACKWARD_SCOPE or e.name.startswith("autograd::engine::evaluate_function")


def _scopes_of(cpu_events) -> dict:
    """id(CPU event) -> (its scope path, backward), or None where it has no
    scope or its autograd node joins no forward op."""
    def chain(e):
        out = []
        while e is not None:
            out.append(e)
            e = e.cpu_parent
        return out

    def scopes(ch):
        return "/".join(a.name for a in reversed(ch) if getattr(a, "is_user_annotation", False))

    chains = {id(e): chain(e) for e in cpu_events}
    # an op run with grad enabled records the thread's next sequence number
    # whether or not it makes an autograd node; the op that makes node N is
    # the last to record N (the next ops record N + 1): the latest one wins
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


def _is_launch(name: str) -> bool:
    """A kernel launch call of the CUDA runtime or driver API."""
    return name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))


def _is_runtime(e) -> bool:
    """A CUDA runtime or driver API call (cudaLaunchKernel, cudaLaunchKernelExC,
    cudaMemcpyAsync, cuLaunchKernel, ...), not an op."""
    return e.name.startswith("cu") and "::" not in e.name


def _launchers(device_events, cpu_events) -> list:
    """For each device op, the innermost CPU op running when its launch
    call started (the op with the latest start whose span holds it), or
    None.  The launch call is the runtime event of the device op's
    correlation id.  The profiler links most kernels to their op itself,
    but not those launched with cudaLaunchKernelEx (the GroupNorm pair's
    clusters and programmatic launch), and its link is not an attribute of
    the events in every torch version: the time join serves all."""
    launch_at = {e.id: e.time_range.start for e in cpu_events if _is_runtime(e)}
    ops = sorted((e for e in cpu_events if not _is_runtime(e)),
                 key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in ops]
    out = []
    for d in device_events:
        t = launch_at.get(d.id)
        found = None
        if t is not None:
            for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
                if ops[i].time_range.end >= t:
                    found = ops[i]
                    break
        out.append(found)
    return out


def attribute_events(events, device_type: str, n_steps: int = 1,
                     component_fn: Callable[[str, bool], str] = default_component) -> dict:
    """Per-component seconds per step from a trace's ``prof.events()``.

    ``device_type`` "cuda": every device kernel, copy and memset (not the
    device-side spans of the user annotations) is charged to the CPU op
    that launched it (``_launchers``); "cpu": every CPU op's self time to
    itself.  The op's scope path is its user annotations, outermost first;
    under an autograd node (the backward pass) it is the path of the
    forward op of the node's sequence number, with ``backward=True``.
    Returns {"total", "components", "unmatched", "scopes" (seconds by
    scope path and direction), "port_kernels" (component -> family ->
    seconds, for the ``distill`` and ``group_norm`` kernels)}, all per step.
    """
    from torch.autograd import DeviceType

    cpu = [e for e in events if e.device_type == DeviceType.CPU and not e.is_async]
    where = _scopes_of(cpu)
    if device_type == "cpu":
        charges = [(e.self_cpu_time_total / 1e6, e, e.name) for e in cpu if not _is_runtime(e)]
    elif device_type == "cuda":
        device = [d for d in events if d.device_type == DeviceType.CUDA
                  and not getattr(d, "is_user_annotation", False)]
        charges = [((d.time_range.end - d.time_range.start) / 1e6, op, d.name)
                   for d, op in zip(device, _launchers(device, cpu))]
    else:
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    comp, scopes_s, port = defaultdict(float), defaultdict(float), defaultdict(dict)
    total = unmatched = 0.0
    for sec, launcher, name in charges:
        total += sec
        joined = None if launcher is None else where.get(id(launcher))
        if joined is None:
            unmatched += sec
            continue
        path, backward = joined
        c = component_fn(path, backward)
        comp[c] += sec
        scopes_s[f"{path} ({'bwd' if backward else 'fwd'})"] += sec
        family = op_category(name)
        if family in PORT_KERNELS:
            port[c][family] = port[c].get(family, 0.0) + sec
    n = max(n_steps, 1)
    per_step = lambda d: {k: v / n for k, v in sorted(d.items(), key=lambda kv: -kv[1])}  # noqa: E731
    return {"total": total / n, "components": per_step(comp), "unmatched": unmatched / n,
            "scopes": per_step(scopes_s),
            "port_kernels": {c: {f: s / n for f, s in fam.items()} for c, fam in port.items()}}


def render_components(att: dict, top_scopes: int = 15) -> str:
    """The component table in ms/step, JAX's layout, then the largest scopes."""
    lines = ["component attribution (ms/step):"]
    lines += [f"  {k:<16} {v * 1e3:9.3f}" for k, v in att["components"].items()]
    lines.append(f"  {'unmatched':<16} {att['unmatched'] * 1e3:9.3f}")
    lines.append(f"  {'total':<16} {att['total'] * 1e3:9.3f}")
    for c, fam in att["port_kernels"].items():
        lines.append(f"  port kernels in {c}: "
                     + ", ".join(f"{f} {s * 1e3:.3f}" for f, s in sorted(fam.items())))
    lines.append(f"top {top_scopes} scopes (ms/step):")
    lines += [f"  {v * 1e3:9.3f}  {k}" for k, v in list(att["scopes"].items())[:top_scopes]]
    return "\n".join(lines)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_step(step_fn: Callable[[], object], trace_dir: str, device: torch.device,
                 n_steps: int = 3, warmup: int = 2):
    """Run ``step_fn()`` ``warmup`` times, then ``n_steps`` times timed on
    the host clock (the unprofiled ms/step), then ``n_steps`` times inside
    one ``torch.profiler`` trace (CPU and, on the card, CUDA).  Writes
    ``trace.json`` and the op table ``ops.txt`` into ``trace_dir``; returns
    ``(key_averages, unprofiled ms/step, op table, the trace's events)``,
    the events for ``attribute_events``."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    for _ in range(warmup):
        step_fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n_steps):
        step_fn()
    _sync(device)
    step_ms = (time.perf_counter() - t0) / n_steps * 1e3
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(n_steps):
            step_fn()
        _sync(device)
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    events = prof.key_averages()
    sort = "self_cuda_time_total" if device.type == "cuda" else "self_cpu_time_total"
    table = events.table(sort_by=sort, row_limit=60)
    with open(os.path.join(trace_dir, "ops.txt"), "w") as f:
        f.write(table)
    return events, step_ms, table, prof.events()


# ---------------------------------------------------------------------------
# spans: the one scope helper, and a recorder on the host's clock
# ---------------------------------------------------------------------------

CLOCK_MARK = "span_clock_mark"
# the marker launched on the card: torch.cuda._sleep's spin kernel
MARK_KERNEL = re.compile(r"spin_kernel")


@dataclass
class Recording:
    """What an open recording keeps: spans ``(name, parent, start_ns,
    end_ns, thread)`` on ``time.perf_counter_ns`` (``parent`` the name of
    the recorded span enclosing it on its thread, or None; ``thread`` the
    native thread id), tallies by name, and the four clock reads of each
    clock marker (``mark_clock``).  A span starts midway between the reads
    around entering its ``record_function`` and ends at the read after
    leaving it: the nearest a host read comes to where a profiler stamps
    the scope."""

    spans: list = field(default_factory=list)
    counts: dict = field(default_factory=lambda: defaultdict(int))
    marks: list = field(default_factory=list)


_recordings: list = []  # the open recordings, each keeps every span
_open = threading.local()  # .names: the recorded spans open on this thread; .thread: its id


class _RecordedSpan:
    __slots__ = ("name", "recs", "scope", "parent", "t0")

    def __init__(self, name: str, recs: tuple):
        self.name, self.recs = name, recs

    def __enter__(self):
        names = getattr(_open, "names", None)
        if names is None:
            names = _open.names = []
            _open.thread = threading.get_native_id()
        self.parent = names[-1] if names else None
        names.append(self.name)
        self.scope = record_function(self.name)
        t = time.perf_counter_ns()
        self.scope.__enter__()
        self.t0 = (t + time.perf_counter_ns()) // 2
        return self

    def __exit__(self, *exc):
        self.scope.__exit__(*exc)
        t1 = time.perf_counter_ns()
        _open.names.pop()
        kept = (self.name, self.parent, self.t0, t1, _open.thread)
        for rec in self.recs:
            rec.spans.append(kept)


def span(name: str):
    """A ``record_function`` scope ``name``, kept as a span by every open
    recording."""
    if not _recordings:
        return record_function(name)
    return _RecordedSpan(name, tuple(_recordings))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the tally ``name`` of every open recording."""
    for rec in _recordings:
        rec.counts[name] += n


def start_recording() -> Recording:
    """Open a recording; one opened inside another keeps the same spans from
    then on, and each is drained and stopped on its own."""
    rec = Recording()
    _recordings.append(rec)
    return rec


def stop_recording(rec: Recording) -> Recording:
    _recordings.remove(rec)
    return rec


@contextlib.contextmanager
def recording():
    """Spans and tallies kept for the body: yields the ``Recording``."""
    rec = start_recording()
    try:
        yield rec
    finally:
        stop_recording(rec)


def drain(rec: Recording) -> tuple[list, dict]:
    """``rec``'s spans and tallies so far, which it then forgets."""
    spans, counts = rec.spans, dict(rec.counts)
    rec.spans, rec.counts = [], defaultdict(int)
    return spans, counts


def mark_clock(device: torch.device | str) -> None:
    """A marker the trace records, its host clock reads kept in the
    ``marks`` of every open recording: a ``record_function`` (what a CPU
    trace records) around one launch of a tiny kernel on a card (what a
    trace of CUDA activity alone records)."""
    device = torch.device(device)
    with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
        t0 = time.perf_counter_ns()
        with record_function(CLOCK_MARK):
            t1 = time.perf_counter_ns()
            if device.type == "cuda":
                torch.cuda._sleep(1)
            t2 = time.perf_counter_ns()
        t3 = time.perf_counter_ns()
    for rec in _recordings:
        rec.marks.append((t0, t1, t2, t3))


def clock_offsets(events, marks: list) -> list[tuple[float, float]]:
    """(start, end) offsets, trace µs minus host µs, at each clock marker
    of ``marks``, in order.

    A marker is four host clock reads: before and after entering its
    ``record_function``, and before and after leaving it, the marker
    kernel's launch between the middle two.  In a trace of the card two
    markers bracket the traced work, so they are its first and last kernel
    launches (checked against their kernel's name where the trace kept the
    kernel: a session can lose the device records of its first kernels,
    never their launch calls); a launch call starts after the second read
    and ends before the third.  In a trace of the CPU the
    ``record_function``'s start is matched with the midpoint of the first
    two reads and its end with the last read, as a span's ends are read
    (``Recording``), so what the profiler adds to entering and leaving a
    scope it records cancels."""
    from torch.autograd import DeviceType

    launches = sorted((e.time_range.start, e.time_range.end, e.id) for e in events
                      if e.device_type == DeviceType.CPU and _is_launch(e.name))
    if launches:
        if len(marks) != 2 or len(launches) < 2:
            raise ValueError(f"a trace of the card with {len(launches)} kernel launches "
                             f"needs 2 clock markers, the recording has {len(marks)}")
        ends = (launches[0], launches[-1])
        kept = {e.id: e.name for e in events if e.device_type == DeviceType.CUDA}
        wrong = [kept[i] for _, _, i in ends if i in kept and not MARK_KERNEL.search(kept[i])]
        if wrong:
            raise ValueError(f"the trace's first or last kernel launch is not a clock "
                             f"marker: {wrong}")
        return [(s - t1 / 1e3, e - t2 / 1e3) for (s, e, _), (_, t1, t2, _) in zip(ends, marks)]
    scopes = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.device_type == DeviceType.CPU and e.name == CLOCK_MARK)
    if len(scopes) != len(marks):
        raise ValueError(f"the trace holds {len(scopes)} clock markers, "
                         f"the recording {len(marks)}")
    return [(s - (t0 + t1) / 2e3, e - t3 / 1e3)
            for (s, e), (t0, t1, t2, t3) in zip(scopes, marks)]


def spans_on_trace(rec: Recording, events) -> tuple[list, float]:
    """(the recording's spans as ``(name, parent, start_us, end_us, thread)``
    on the trace's timeline, the drift in µs between its first and last
    clock markers).  Each offset is the first marker's, moved linearly to
    the last one's between them (one marker: constant)."""
    off = clock_offsets(events, rec.marks)
    if not off:
        raise ValueError("the recording has no clock marker")
    (s0, e0), (s1, e1) = off[0], off[-1]
    h0, h1 = rec.marks[0][0] / 1e3, rec.marks[-1][0] / 1e3
    span_us = h1 - h0 if h1 > h0 else math.inf

    def at(ns, first, last):
        us = ns / 1e3
        return us + first + (last - first) * (us - h0) / span_us

    return ([(n, p, at(s, s0, s1), at(e, e0, e1), t) for n, p, s, e, t in rec.spans],
            (s1 + e1 - s0 - e0) / 2)
