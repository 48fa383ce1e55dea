"""Device-time breakdown of a train step from a ``torch.profiler`` trace.

Counterpart of ``diga_tpu/utils/profiling.py`` (:1-160) on
``torch.profiler``: ``profile_step`` runs a step a few times to warm up,
times it without the profiler (the unprofiled ms/step), then traces
``n_steps`` more with CPU and CUDA activities; ``ProfileReport`` sums the
device kernels and copies by family (``op_category``) and by name, per
step, and gives the busy share (device time over the unprofiled step
time).  The JAX module's xplane and HLO parts (:163-252: the compiled-HLO
metadata join) have no counterpart: there is no XLA program here, and the
category table and the kernel names are the attribution.
"""

from __future__ import annotations

import os
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable

import torch

# the port's own kernels (csrc/distill.cu: B1a/B1b; csrc/group_norm.cu: B2a/B2b)
PORT_KERNELS = {"distill": re.compile(r"(?<![A-Za-z0-9])distill_\w+"),
                "group_norm": re.compile(r"(?<![A-Za-z0-9])gn_\w+")}
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
        if e.device_type != DeviceType.CUDA:
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_step(step_fn: Callable[[], object], trace_dir: str, device: torch.device,
                 n_steps: int = 3, warmup: int = 2):
    """Run ``step_fn()`` ``warmup`` times, then ``n_steps`` times timed on
    the host clock (the unprofiled ms/step), then ``n_steps`` times inside
    one ``torch.profiler`` trace (CPU and, on the card, CUDA).  Writes
    ``trace.json`` and the op table ``ops.txt`` into ``trace_dir``; returns
    ``(key_averages, unprofiled ms/step, op table)``."""
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
    return events, step_ms, table
