"""Component attribution of the train steps (CPU).

* ``utils/profiling.default_component`` gives ``diga_tpu``'s answer over a
  table of jax op paths, with ``backward = "transpose(" in path``;
* a CPU trace of the tiny warm-up, self-training and translator steps
  leaves at most 5 % of the CPU op time ``unmatched``, and charges the
  parts where they belong: the model's forward and backward, the frozen
  translator, the photometric chain and CrDoMix, the losses, the EMA and
  the optimizer;
* the steps' outputs and parameters are bitwise unchanged under the
  profiler and with the scopes taken out;
* the card's join, on a synthetic trace: a kernel is charged to the
  innermost op running when its launch call (``cudaLaunchKernel`` or
  ``cudaLaunchKernelEx``, the runtime event of its correlation id)
  started, a backward kernel to its node's forward scopes, and a kernel
  with no launch call is ``unmatched``;
* ``profile_step --components`` prints the table on the CPU.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import EventList, FunctionEvent
from torch.profiler import ProfilerActivity, profile

from diga_tpu.utils import profiling as jax_profiling
import diga_tpu_torch.cli.profile_step as profile_step
from diga_tpu_torch.cli.train_domain_translator import build_translator_experiment
from diga_tpu_torch.configs import presets
from diga_tpu_torch.train import steps as steps_mod
from diga_tpu_torch.train.build import build_experiment
from diga_tpu_torch.utils import profiling
from diga_tpu_torch.utils.synth import synth_batch

COMPONENTS = {"translator_fwd", "model_fwd", "model_bwd", "optimizer_ema", "aug_mix",
              "loss_resize", "misc"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on one host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


JAX_PATHS = [
    "jit(step)/jit(main)/DeepLabV2/layer1_0/conv1/conv_general_dilated",
    "jit(step)/jit(main)/transpose(jvp(DeepLabV2))/layer4_0/conv2/conv_general_dilated",
    "jit(step)/jit(main)/HRNet/stage2/branch0/add",
    "jit(step)/jit(main)/transpose(jvp(HRNet))/stage4/fuse/mul",
    "jit(step)/jit(main)/crdomix/ImgEncoder/Conv_0/conv_general_dilated",
    "jit(step)/jit(main)/transpose(jvp(ImgDecoder))/ResBlocks_0/add",
    "jit(step)/jit(main)/ImgEncoder/DeepLabV2/mixed",
    "jit(step)/jit(main)/sgd/mul",
    "jit(step)/jit(main)/ema/add",
    "jit(step)/jit(main)/tree_map/add_decayed_weights/mul",
    "jit(step)/jit(main)/trace_update/mul",
    "jit(step)/jit(main)/apply_updates/add",
    "jit(step)/jit(main)/scale_by_adam/sqrt",
    "jit(step)/jit(main)/masked/select_n",
    "jit(step)/jit(main)/opt/update/mul",
    "jit(step)/jit(main)/photometric/hsv/max",
    "jit(step)/jit(main)/crdomix/select_n",
    "jit(step)/jit(main)/rgb_to_hsv/sub",
    "jit(step)/jit(main)/distill/reduce_sum",
    "jit(step)/jit(main)/transpose(jvp(cross_entropy))/mul",
    "jit(step)/jit(main)/log_softmax/reduce_max",
    "jit(step)/jit(main)/resize/dot_general",
    "jit(step)/jit(main)/transpose(jvp(resize))/dot_general",
    "jit(step)/jit(main)/prototypes/masked_class_means/dot_general",
    "jit(step)/jit(main)/photometric/distill/mul",
    "jit(step)/jit(main)/schema/dot_general",
    "jit(step)/jit(main)/bilateral_consensus/eq",
    "jit(step)/jit(main)/Discriminator/conv_general_dilated",
    "",
]


def test_default_component_is_the_jax_rule():
    seen = set()
    for path in JAX_PATHS:
        want = jax_profiling.default_component(path)
        got = profiling.default_component(path, "transpose(" in path)
        assert got == want, path
        seen.add(got)
    assert seen == COMPONENTS


def _tiny(name, widths=None):
    p = presets.get_preset(name)
    return dataclasses.replace(
        p, data=dataclasses.replace(
            p.data, source_streams=(presets.LoaderSpec("gta5", (32, 64), 1),),
            target_streams=(presets.LoaderSpec("cityscapes", (32, 64), 1),)),
        train=dataclasses.replace(p.train, crop_hw=(32, 64), compute_dtype="float32"),
        extra={**p.extra, **(widths or {"layers": (1, 1, 1, 1)})})


TRANSLATOR_WIDTHS = {"enc_dim": 8, "dec_dim": 32, "n_res": 1, "dis_dim": 8, "dis_layers": 2,
                     "dis_scales": 2}


def _build(name):
    """(state, step, batch) of a tiny copy of preset ``name`` on the CPU."""
    if name == "gta2city_translator":
        cfg = _tiny(name, TRANSLATOR_WIDTHS)
        state, step = build_translator_experiment(cfg, torch.device("cpu"))
        batch = synth_batch(dataclasses.replace(cfg, stage="warmup"), "cpu")
    else:
        cfg = _tiny(name)
        state, step, _ = build_experiment(cfg, torch.device("cpu"))
        batch = synth_batch(cfg, "cpu")
    return state, step, batch


def _params(state):
    modules = state.modules.values() if hasattr(state, "modules") else [state.student,
                                                                          state.teacher]
    return [p.detach().clone() for m in modules for p in m.state_dict().values()]


@pytest.mark.parametrize("name", ["gta2city_warmup", "gta2city_selftrain",
                                  "gta2city_translator"])
def test_cpu_trace_is_attributed(name):
    state, step, batch = _build(name)
    step(state, batch)  # the first step's allocations
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    att = profiling.attribute_events(prof.events(), "cpu")
    assert att["total"] > 0 and att["unmatched"] <= 0.05 * att["total"], att
    comps = att["components"]
    assert set(comps) <= COMPONENTS
    assert sum(comps.values()) + att["unmatched"] == pytest.approx(att["total"])
    if name == "gta2city_translator":
        assert {"translator_fwd", "optimizer_ema", "misc"} <= set(comps)
        assert comps["translator_fwd"] > 0.3 * att["total"]  # as in JAX, its backward too
    else:
        assert {"model_fwd", "model_bwd", "translator_fwd", "optimizer_ema", "aug_mix",
                "loss_resize"} <= set(comps)
        assert comps["model_bwd"] > comps["loss_resize"]
        scopes = att["scopes"]
        for key in ("train_step/DeepLabV2 (fwd)", "train_step/DeepLabV2 (bwd)",
                    "train_step/crdomix/ImgEncoder (fwd)", "train_step/photometric (fwd)",
                    "train_step/distill (bwd)", "train_step/cross_entropy (fwd)",
                    "train_step/ema (fwd)"):
            assert key in scopes, sorted(scopes)
        if name == "gta2city_selftrain":
            assert "train_step/prototypes (fwd)" in scopes
            assert "train_step/crdomix/dacs (fwd)" in scopes


@pytest.mark.parametrize("name", ["gta2city_warmup", "gta2city_translator"])
def test_scopes_change_no_value(name, monkeypatch):
    runs = []
    for mode in ("plain", "profiled", "unscoped"):
        with monkeypatch.context() as m:
            if mode == "unscoped":  # every scope a no-op
                m.setattr(steps_mod, "scope", lambda name: contextlib.nullcontext())
                m.setattr("diga_tpu_torch.train.steps_translator.scope",
                          lambda name: contextlib.nullcontext())
            torch.manual_seed(0)
            state, step, batch = _build(name)
            ctx = profile(activities=[ProfilerActivity.CPU]) if mode == "profiled" \
                else contextlib.nullcontext()
            with ctx:
                metrics = [step(state, batch) for _ in range(2)]
        runs.append(({k: v.clone() for k, v in metrics[-1].items()}, _params(state)))
    (m0, p0), others = runs[0], runs[1:]
    for m1, p1 in others:
        assert m1.keys() == m0.keys()
        for k in m0:
            assert torch.equal(m0[k], m1[k]), k
        assert len(p0) == len(p1) and all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_cuda_join_on_a_synthetic_trace():
    def ev(i, name, t0, t1, thread=1, **kw):
        return FunctionEvent(id=i, name=name, thread=thread, start_us=t0, end_us=t1, **kw)

    ua = dict(is_user_annotation=True)
    cpu = [ev(1, "train_step", 0, 100, **ua), ev(2, "DeepLabV2", 1, 40, **ua),
           ev(3, "aten::convolution", 2, 10, sequence_nr=7),
           ev(90, "cudaLaunchKernel", 3, 4, thread=99),  # the runtime's own thread id
           ev(91, "cudaLaunchKernelExC", 20, 21, thread=99),  # inside DeepLabV2, no op
           ev(4, "distill", 50, 60, **ua), ev(5, "DistillationLoss", 51, 59, sequence_nr=8),
           ev(92, "cudaLaunchKernel", 52, 53, thread=99),
           ev(6, "autograd::engine::evaluate_function: ConvolutionBackward0", 70, 80,
              thread=2, sequence_nr=7, fwd_thread=1),
           ev(7, "aten::convolution_backward", 71, 79, thread=2),
           ev(93, "cudaLaunchKernel", 72, 73, thread=99)]
    dev = [ev(90, "sm90_xmma_fprop", 5, 9, device_type=DeviceType.CUDA),
           ev(91, "void gn_stats_kernel<bf16>", 22, 23, device_type=DeviceType.CUDA),
           ev(92, "distill_partial_kernel", 54, 58, device_type=DeviceType.CUDA),
           ev(93, "sm90_xmma_wgrad", 74, 78, device_type=DeviceType.CUDA),
           ev(94, "memset", 90, 91, device_type=DeviceType.CUDA),  # no launch call
           ev(2, "DeepLabV2", 5, 23, device_type=DeviceType.CUDA, **ua)]  # a span, not an op
    events = EventList(cpu + dev)
    events._build_tree()
    att = profiling.attribute_events(events, "cuda")
    assert att["total"] == pytest.approx(14e-6)
    assert att["unmatched"] == pytest.approx(1e-6)
    assert att["components"] == pytest.approx({"model_fwd": 5e-6, "model_bwd": 4e-6,
                                               "loss_resize": 4e-6})
    assert att["port_kernels"] == {"model_fwd": {"group_norm": pytest.approx(1e-6)},
                                   "loss_resize": {"distill": pytest.approx(4e-6)}}


def test_profile_step_components_on_the_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setitem(presets.PRESETS, "tiny_components_dg", _tiny("dg_gta5"))
    rep = profile_step.main(["--preset", "tiny_components_dg", "--device", "cpu", "--steps", "1",
                             "--trace_dir", str(tmp_path), "--components"])
    out = capsys.readouterr().out
    assert "no device ops" in out and "component attribution (ms/step):" in out
    att = rep.components
    assert att["unmatched"] <= 0.05 * att["total"]
    assert {"model_fwd", "model_bwd", "optimizer_ema", "aug_mix", "loss_resize"} <= set(
        att["components"])
    for name in att["components"]:
        assert f"  {name:<16}" in out
    assert np.isfinite(att["total"])
