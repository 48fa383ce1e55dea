"""The FLOP and byte counters, and the trace reductions, on hand-worked shapes."""

from __future__ import annotations

import math

import pytest
import torch
import torch.nn as nn

from benchmark.harness import counts, metrics
from benchmark.harness.peaks import TABLE, for_device
from benchmark.harness.trace import Trace, _union

H100 = TABLE["H100"]


def test_flops_of_a_conv_and_a_linear_by_hand():
    conv = nn.Conv2d(8, 16, 3, padding=1, device="meta")
    x = torch.empty(2, 8, 5, 7, device="meta")
    # 2 FLOPs x out pixels (2*5*7) x out channels 16 x in channels 8 x 3*3 taps
    assert counts._flops(lambda: conv(x)) == 2 * (2 * 5 * 7) * 16 * 8 * 9
    lin = nn.Linear(12, 4, device="meta")
    assert counts._flops(lambda: lin(torch.empty(3, 12, device="meta"))) == 2 * 3 * 12 * 4


def test_ocr_attention_products_are_counted():
    a, b = torch.empty(2, 6, 5, device="meta"), torch.empty(2, 5, 3, device="meta")
    assert counts._flops(lambda: torch.bmm(a, b)) == 2 * 2 * 6 * 5 * 3


def test_train_step_counts_teacher_student_stats_and_translator():
    from benchmark.tests.tiny import tiny_cell

    cell = tiny_cell("r101_gta2city_warmup")
    tr, cfg = cell.traffic, cell.config
    b, hw = tr["source_batch"], tr["crop_hw"]
    fwd = counts.model_forward_flops(cfg, 2 * b, hw)
    want = (4 * fwd + counts.stats_forward_flops(cfg, tr["target_batch"], hw)
            + counts.translator_flops(cfg, b, hw))
    assert counts.train_step_flops(cfg, tr) == want
    assert counts.stats_forward_flops(cfg, 1, hw) < counts.model_forward_flops(cfg, 1, hw)
    # a forward is linear in the batch
    assert counts.model_forward_flops(cfg, 2, hw) == 2 * counts.model_forward_flops(cfg, 1, hw)


def test_group_norm_sites_of_the_aspp_head():
    from benchmark.tests.tiny import tiny_cell

    cfg = tiny_cell("r101_gta2city_warmup").config
    # 32x64: conv/2 -> 16x32, ceil-mode pool -> 9x17, layer2's stride -> 5x9
    assert counts.group_norm_inputs(cfg, 6, (32, 64)) == [(6, 5, 9, 256)] * 6


def test_kernel_least_times_by_hand():
    shape = (6, 512, 896, 19)
    numel = math.prod(shape)
    # bf16: B1a reads t and s, B1b reads both and writes the gradient
    want = (2 * numel * 2 + 4) / 3.35e12 + (3 * numel * 2 + 4) / 3.35e12
    assert counts.distill_least_s(shape, 2, H100) == pytest.approx(want, rel=1e-12)
    gn = (1, 129, 257, 256)
    assert counts.group_norm_least_s(gn, 2, H100) == pytest.approx(
        (2 * math.prod(gn) * 2 + 2 * 256 * 4) / 3.35e12, rel=1e-12)
    # a tiny site is bound by its f32 operations, not its bytes
    assert counts.least_s(10, 1e9, H100) == pytest.approx(1e9 / 67e12)


def _trace(ops, units=2, window=1.0, busy=0.5):
    return Trace(units=units, window_s=window, busy_s=busy, device_ops=ops, components={
        "model_fwd": 0.05, "model_bwd": 0.04, "aug_mix": 0.001},
        program_spans_s={"train_step": [0.2, 0.3]}, top_ops=[], idle_gaps=[])


def test_kernel_roofline_and_its_silences():
    shape = (2, 4, 4, 19)
    least = counts.distill_least_s(shape, 2, H100)
    us = least * 1e6
    ops = []
    for u in range(2):  # two steps, one call each: B1a (two launches) and B1b
        t = u * 100.0
        ops += [("void distill_partial_kernel<bf16>", t, t + us), ("distill_fold_kernel", t + us,
                t + 1.5 * us), ("distill_grad_kernel", t + 2 * us, t + 4 * us)]
    ctx = metrics.Context(trace=_trace(ops), units_per_s=5.0, unit_flops=int(1e12), peaks=H100,
                          kernel_sites={"distill": [shape]}, elem_bytes=2)
    # least time of 2 calls over 2 x 3.5 least times of device time
    assert metrics.kernel_roofline(ctx, "distill") == pytest.approx(100 * 2 / 7, rel=1e-9)
    ctx.kernel_sites = {"distill": [shape, shape]}  # the trace shows another number of calls
    assert metrics.kernel_roofline(ctx, "distill") is None
    assert metrics.kernel_roofline(ctx, "gn") is None  # the family did not run
    assert metrics.mfu(ctx) == pytest.approx(100 * 5e12 / 989e12)
    assert metrics.idle_share(ctx) == pytest.approx(50.0)
    assert metrics.component_ms(ctx, ("model_fwd", "model_bwd")) == pytest.approx(90.0)
    assert metrics.component_ms(ctx, ("translator_fwd",)) is None


def test_every_reader_loads_and_reads():
    ctx = metrics.Context(trace=_trace([("gn_stats_kernel", 0.0, 5.0)]), units_per_s=1.0,
                          unit_flops=1, peaks=H100, kernel_sites={}, elem_bytes=2)
    from benchmark.harness import manifest

    for m in manifest.load()["per_layer"]:
        value = metrics.load_reader(m["name"])(ctx)
        assert value is None or math.isfinite(value)
    assert metrics.load_reader("step_host_ms.train")(ctx) == pytest.approx(250.0)


def test_busy_time_is_a_union_not_a_sum():
    assert _union([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]


def test_peaks_by_card_name():
    assert for_device("NVIDIA H100 80GB HBM3") is H100
    with pytest.raises(ValueError):
        for_device("cpu")
