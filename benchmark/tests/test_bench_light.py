"""The light window's reductions (``harness/light.py``) on synthetic lists.

Host clock = trace clock - 100 µs; two units of one ``train_step`` each,
the first holding ``DeepLabV2`` and ``sgd``; four device ops; the markers'
kernels and launches are left out of every number.
"""

from __future__ import annotations

import pytest

from benchmark.harness import light as L

MARKS = [(0, 1_000, 3_000, 4_000), (1_000_000, 1_001_000, 1_003_000, 1_004_000)]
SPANS = [  # (name, parent, start_ns, end_ns, thread) on the host's clock
    ("DeepLabV2", "train_step", 50_000, 200_000, 1),
    ("sgd", "train_step", 300_000, 390_000, 1),
    ("train_step", None, 20_000, 400_000, 1),
    ("bench_unit", None, 10_000, 410_000, 1),
    ("train_step", None, 510_000, 890_000, 1),
    ("bench_unit", None, 500_000, 900_000, 1),
]
DEVICE = [  # (name, start_us, end_us, correlation id) on the trace's clock
    ("void at::cuda::spin_kernel(long)", 104.0, 105.0, 1),
    ("sm90_xmma_fprop", 120.0, 160.0, 10),
    ("batch_norm_collect_statistics", 200.0, 350.0, 11),
    ("Memcpy HtoD (Pinned -> Device)", 450.0, 700.0, 12),
    ("gn_stats_kernel", 800.0, 1000.0, 13),
    ("void at::cuda::spin_kernel(long)", 1104.0, 1105.0, 2),
]
RUNTIME = [
    ("cudaLaunchKernel", 101.0, 103.0, 1),
    ("cudaLaunchKernel", 125.0, 127.0, 10),
    ("cudaLaunchKernel", 205.0, 207.0, 11),
    ("cudaMemcpyAsync", 300.0, 302.0, 20),
    ("cudaMemcpyAsync", 445.0, 447.0, 12),
    ("cudaStreamSynchronize", 480.0, 485.0, 21),
    ("cudaLaunchKernelExC", 805.0, 807.0, 13),
    ("cudaDeviceSynchronize", 1010.0, 1020.0, 22),
    ("cudaLaunchKernel", 1050.0, 1052.0, 14),
    ("cudaLaunchKernel", 1101.0, 1103.0, 2),
]


@pytest.fixture(scope="module")
def light():
    return L.reduce_light(DEVICE, RUNTIME, SPANS, MARKS, 2)


def test_the_clock_offset_is_read_from_the_marker_launches():
    offsets = L.clock_offsets([(101.0, 103.0), (1101.0, 1103.0)], MARKS)
    assert offsets == [(100.0, 100.0), (100.0, 100.0)]
    drifting = L.clock_offsets([(101.0, 103.0), (1103.0, 1105.0)], MARKS)
    (span,), drift = L.on_trace([("x", None, 500_000, 900_000, 1)], MARKS, drifting)
    assert drift == pytest.approx(2.0)
    assert span[2] == pytest.approx(500.0 + 100.0 + 2 * 500 / 1000)
    assert span[3] == pytest.approx(900.0 + 100.0 + 2 * 900 / 1000)
    with pytest.raises(ValueError, match="clock marker"):
        L.clock_offsets([(101.0, 103.0)], MARKS)


def test_the_markers_are_the_first_and_last_launches():
    lost = L.reduce_light(DEVICE[1:], RUNTIME, SPANS, MARKS, 2)  # the first kernel's record lost
    assert lost.drift_us == pytest.approx(0.0) and lost.launches == 4
    not_a_marker = [("sm90_xmma_fprop", 104.0, 105.0, 1)] + DEVICE[1:]
    with pytest.raises(ValueError, match="not a clock marker"):
        L.reduce_light(not_a_marker, RUNTIME, SPANS, MARKS, 2)
    with pytest.raises(ValueError, match="expected 2 markers"):
        L.reduce_light(DEVICE, RUNTIME, SPANS, MARKS[:1], 2)


def test_spans_land_on_the_trace_and_markers_are_left_out(light):
    assert light.drift_us == pytest.approx(0.0)
    unit = [(s, e) for n, _, s, e, _ in light.spans if n == "bench_unit"]
    assert unit == [pytest.approx((110.0, 510.0)), pytest.approx((600.0, 1000.0))]
    assert [n for n, _, _ in light.device_ops] == [n for n, *_ in DEVICE[1:5]]


def test_the_window_and_its_idle_share(light):
    assert light.window_s == pytest.approx(890e-6)
    assert light.busy_s == pytest.approx(640e-6)
    assert light.idle_share() == pytest.approx(100.0 * 250 / 890)
    assert light.unit_ms() == pytest.approx(0.445)


def test_idle_time_is_split_by_the_innermost_program_span(light):
    assert light.idle_by_span == pytest.approx({L.OUTSIDE: 10e-6, "DeepLabV2": 40e-6,
                                                "train_step": 150e-6, "sgd": 50e-6})
    assert light.idle_unnamed_share() == pytest.approx(4.0)
    assert [n for n, _ in light.top_idle(2)] == ["train_step", "sgd"]
    assert "train_step 0.075" in L.idle_line(light)


def test_split_by_innermost_cuts_at_every_span_edge():
    spans = [("a", 0.0, 100.0), ("b", 10.0, 20.0), ("c", 30.0, 40.0)]
    got = L.split_by_innermost([(5.0, 35.0), (90.0, 120.0)], spans)
    assert got == pytest.approx({"a": 25e-6, "b": 10e-6, "c": 5e-6, L.OUTSIDE: 20e-6})


def test_synchronising_calls_are_charged_to_their_span(light):
    assert light.syncs == {"sgd": 1, L.OUTSIDE: 1}
    assert [n for n, _ in light.sync_calls] == ["cudaStreamSynchronize",
                                                "cudaDeviceSynchronize"]
    assert light.syncs_per_unit("train_step") == pytest.approx(0.5)
    assert light.syncs_per_unit("eval_update") is None


def test_kernel_launches_inside_units(light):
    assert (light.launches, light.launches_in_units) == (4, 3)
    assert light.launch_share_in_units() == pytest.approx(75.0)


def test_span_means(light):
    assert light.mean_span_ms("train_step") == pytest.approx(0.38)
    assert light.span_ms_per_unit("DeepLabV2") == pytest.approx(0.075)
    assert light.mean_span_ms("h2d") is None and light.span_ms_per_unit("h2d") is None


def test_nothing_to_read_reads_none():
    empty = L.reduce_light(DEVICE[:1] + DEVICE[-1:], RUNTIME[:1] + RUNTIME[-1:],
                           [("bench_unit", None, 10_000, 410_000, 1)], MARKS, 1)
    assert empty.window_s == 0.0 and empty.device_ops == []
    assert empty.idle_share() is None and empty.idle_unnamed_share() is None
    assert empty.mean_span_ms("train_step") is None
    assert empty.syncs_per_unit("train_step") is None
    assert empty.unit_ms() is None and empty.launch_share_in_units() is None
