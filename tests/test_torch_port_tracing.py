"""The port's spans and their recorder (``utils/profiling.py``), on the CPU.

* with no recording open a ``span`` is a bare ``record_function`` and
  nothing is kept; an open recording keeps each span with its parent,
  its thread and its tallies, and recordings nest;
* a warm-up step and an evaluator update give bitwise the same values with
  no recording, with one, under the profiler, and under both;
* the recorder's spans, moved onto a CPU trace's timeline by the clock
  markers, lie within 50 µs of their ``record_function`` events at both
  ends; on a synthetic card trace the offset is read from the marker
  kernel's launch call;
* the evaluator's spans form ``eval_update/{h2d, DeepLabV2, resize,
  merge_argmax, confusion}``, and the CPU attribution of an update leaves
  at most 5 % of its op time unmatched.
"""

import dataclasses
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import FunctionEvent
from torch.profiler import ProfilerActivity, profile

from diga_tpu_torch.configs import presets
from diga_tpu_torch.eval.evaluator import TwoScaleEvaluator
from diga_tpu_torch.train.build import build_eval, build_experiment
from diga_tpu_torch.utils import profiling
from diga_tpu_torch.utils.synth import synth_batch

CPU = torch.device("cpu")
OUT_HW, DS_HW = (32, 64), (16, 32)
MODES = ("recorded", "profiled", "recorded_and_profiled")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on one host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tiny_warmup():
    p = presets.get_preset("gta2city_warmup")
    return dataclasses.replace(
        p, data=dataclasses.replace(
            p.data, source_streams=(presets.LoaderSpec("gta5", (32, 64), 1),),
            target_streams=(presets.LoaderSpec("cityscapes", (32, 64), 1),)),
        train=dataclasses.replace(p.train, crop_hw=(32, 64), compute_dtype="float32"),
        eval=presets.EvalConfig(out_hw=OUT_HW, ds_hw=DS_HW),
        extra={**p.extra, "layers": (1, 1, 1, 1)})


def _image_and_label(seed=0):
    rr = np.random.default_rng(seed)
    image = (rr.normal(size=(1, *OUT_HW, 3)) * 0.5).astype(np.float32)
    label = rr.integers(0, 19, size=(1, *OUT_HW)).astype(np.int32)
    label[:, :4] = 255
    return image, label


def _warmup_values():
    torch.manual_seed(0)
    cfg = _tiny_warmup()
    state, step, _ = build_experiment(cfg, CPU)
    batch = synth_batch(cfg, CPU)
    metrics = [step(state, batch) for _ in range(2)]
    params = [p.detach().clone() for m in (state.student, state.teacher)
              for p in m.state_dict().values()]
    return [v.clone() for v in metrics[-1].values()] + params


def _evaluator():
    apply_fn, _ = build_eval(_tiny_warmup(), None, CPU)
    return TwoScaleEvaluator(apply_fn, 19, OUT_HW, DS_HW, CPU)


def _eval_values():
    ev = _evaluator()
    preds = [ev.update(*_image_and_label(s)) for s in range(2)]
    return preds + [ev.score.confusion.clone()]


RUNS = {"warmup_step": _warmup_values, "eval_update": _eval_values}


@pytest.fixture(scope="module")
def plain_values():
    return {name: run() for name, run in RUNS.items()}


def test_no_recording_keeps_nothing():
    assert not profiling._recordings
    s = profiling.span("x")
    assert isinstance(s, torch.profiler.record_function)
    profiling.count("syncs", 3)  # a no-op
    with s:
        rec = profiling.start_recording()  # opened inside: the open span is not kept
    profiling.stop_recording(rec)
    with profiling.span("after"):
        pass
    assert rec.spans == [] and dict(rec.counts) == {}


def test_a_recording_keeps_spans_parents_threads_and_tallies():
    seen = []
    with profiling.recording() as outer:
        with profiling.span("a"):
            with profiling.span("b"):
                profiling.count("syncs", 2)
            inner = profiling.start_recording()
            with profiling.span("c"):
                profiling.count("syncs")
            profiling.stop_recording(inner)

        def other():
            with profiling.span("t"):
                seen.append(threading.get_native_id())

        th = threading.Thread(target=other)
        th.start()
        th.join()
        spans, counts = profiling.drain(outer)
        with profiling.span("d"):
            pass
    assert [(n, p) for n, p, *_ in spans] == [("b", "a"), ("c", "a"), ("a", None), ("t", None)]
    assert all(s < e for _, _, s, e, _ in spans)
    assert spans[-1][4] == seen[0] != spans[0][4]
    assert counts == {"syncs": 3}
    assert [n for n, *_ in inner.spans] == ["c"] and dict(inner.counts) == {"syncs": 1}
    assert [n for n, *_ in outer.spans] == ["d"]  # drained, then kept on
    assert not profiling._recordings


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(RUNS))
def test_recording_and_profiling_change_no_value(name, mode, plain_values):
    rec = profiling.start_recording() if mode != "profiled" else None
    try:
        if mode == "recorded":
            values = RUNS[name]()
        else:
            with profile(activities=[ProfilerActivity.CPU]):
                values = RUNS[name]()
    finally:
        if rec is not None:
            profiling.stop_recording(rec)
    if rec is not None:
        assert rec.spans
    want = plain_values[name]
    assert len(values) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(values, want))


def _annotations(events, names):
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CPU and e.name in names),
                  key=lambda x: (x[0], x[1]))


def test_recorded_spans_land_on_their_cpu_trace_events():
    """Up to three traced steps: one in which the host was not preempted
    inside a scope's enter or exit must put every span within 50 µs."""
    cfg = _tiny_warmup()
    state, step, _ = build_experiment(cfg, CPU)
    batch = synth_batch(cfg, CPU)
    step(state, batch)  # the first step's allocations
    worst = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.recording() as rec:
            profiling.mark_clock(CPU)
            step(state, batch)
            profiling.mark_clock(CPU)
        spans, drift = profiling.spans_on_trace(rec, prof.events())
        names = {n for n, *_ in spans}
        assert {"train_step", "DeepLabV2", "photometric", "sgd", "ImgEncoder"} <= names
        mapped = sorted(((n, s, e) for n, _, s, e, _ in spans), key=lambda x: (x[0], x[1]))
        traced = _annotations(prof.events(), names)
        assert [n for n, *_ in mapped] == [n for n, *_ in traced]
        worst.append(max(max(abs(a[1] - b[1]), abs(a[2] - b[2]), abs(drift))
                         for a, b in zip(mapped, traced)))
        if worst[-1] < 50.0:
            break
    assert worst[-1] < 50.0, worst


def _ev(i, name, t0, t1, device_type=DeviceType.CPU, **kw):
    return FunctionEvent(id=i, name=name, thread=1, start_us=t0, end_us=t1,
                         device_type=device_type, **kw)


def test_the_offset_is_read_from_the_marker_kernels_launch():
    cuda = DeviceType.CUDA
    events = [_ev(7, "cudaLaunchKernel", 1000.0, 1004.0),
              _ev(7, "void at::cuda::spin_kernel(long)", 1010.0, 1011.0, cuda),
              _ev(8, "cudaLaunchKernel", 1100.0, 1104.0),  # the traced work's launch
              _ev(8, "sm90_xmma_fprop", 1110.0, 1200.0, cuda),
              _ev(9, "cudaStreamSynchronize", 1105.0, 1201.0),
              _ev(10, "cudaLaunchKernel", 5000.0, 5004.0),
              _ev(10, "void at::cuda::spin_kernel(long)", 5010.0, 5011.0, cuda)]
    # host clock reads (ns) of the two markers, the launch between the middle
    # two: trace = host + 400 µs at the first, + 402 µs at the second
    rec = profiling.Recording(marks=[(599_000, 600_000, 603_000, 604_000),
                                     (4_597_000, 4_598_000, 4_602_000, 4_603_000)],
                              spans=[("train_step", None, 700_000, 1_700_000, 1)])
    want = [(400.0, 401.0), (402.0, 402.0)]
    assert profiling.clock_offsets(events, rec.marks) == pytest.approx(want)
    # a session that lost the first kernel's device record keeps its launch
    assert profiling.clock_offsets(events[:1] + events[2:], rec.marks) == pytest.approx(want)
    (span,), drift = profiling.spans_on_trace(rec, events)
    assert drift == pytest.approx(1.5)
    assert span[2] == pytest.approx(700.0 + 400.0 + 2 * 101 / 3998)
    assert span[3] == pytest.approx(1700.0 + 401.0 + 1101 / 3998)
    with pytest.raises(ValueError, match="2 clock markers"):
        profiling.clock_offsets(events, rec.marks[:1])
    with pytest.raises(ValueError, match="not a clock marker"):
        profiling.clock_offsets(events[:5], rec.marks)


def test_the_evaluators_spans_and_attribution():
    ev = _evaluator()
    image, label = _image_and_label()
    ev.update(image, label)  # the first update's allocations
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.recording() as rec:
        ev.update(image, label)
    tree = Counter((n, p) for n, p, *_ in rec.spans)
    assert tree == {("eval_update", None): 1, ("h2d", "eval_update"): 1,
                    ("DeepLabV2", "eval_update"): 2, ("resize", "eval_update"): 3,
                    ("merge_argmax", "eval_update"): 1, ("confusion", "eval_update"): 1}
    att = profiling.attribute_events(prof.events(), "cpu")
    assert att["total"] > 0 and att["unmatched"] <= 0.05 * att["total"], att
    assert "model_fwd" in att["components"] and "loss_resize" in att["components"]
