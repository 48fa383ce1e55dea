"""A new family and a new optimizer enter the benchmark as files alone.

``fixtures/families/toy_net.py`` (a small conv net with BN, a head, and
random draws of its own) and ``fixtures/optimizers/toy_adamw.py`` are
found by name through the lookups the cells use (``reference.family``,
``reference.optimizer``), with the fixture folders added to the search
path of ``reference/families`` and ``reference/optimizers`` where a real
one would be a file; ``fixtures/toy_net.json`` and ``toy_batch.json`` are
its configuration and traffic.  No file of the harness or the reference
knows them: seeded weights, the FLOP count, the reference's readings, the
check of the preset and the trace reduction take them as they are.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import reference
from benchmark.harness import counts, manifest, program, train_cell
from benchmark.harness.trace import Scopes, reduce_events
from benchmark.harness.weights import seeded_state, shapes_of

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CPU = torch.device("cpu")
SEED = 2**31 + 77


@pytest.fixture
def toy(monkeypatch):
    from benchmark.reference import families, optimizers

    monkeypatch.setattr(families, "__path__",
                        [*families.__path__, os.path.join(FIXTURES, "families")])
    monkeypatch.setattr(optimizers, "__path__",
                        [*optimizers.__path__, os.path.join(FIXTURES, "optimizers")])
    with open(os.path.join(FIXTURES, "toy_net.json")) as f:
        config = json.load(f)
    with open(os.path.join(FIXTURES, "toy_batch.json")) as f:
        traffic = json.load(f)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield config, traffic
    torch.set_num_threads(threads)
    for name in ("families.toy_net", "optimizers.toy_adamw"):
        sys.modules.pop(f"benchmark.reference.{name}", None)


def test_seeded_weights_take_the_family_rule(toy):
    config, traffic = toy
    shapes = shapes_of(reference.build_model(config))
    plain = seeded_state(shapes, 5, CPU)
    ruled = train_cell.Inputs(config, traffic, SEED, CPU).weights
    assert set(ruled) == set(shapes)
    for state, lo, hi in ((plain, 0.8, 1.2), (ruled, 0.1, 0.3)):
        scale = state["block_bn.weight"]
        assert lo <= float(scale.min()) and float(scale.max()) <= hi
    assert 0.8 <= float(ruled["stem_bn.weight"].min())  # the default rule for the rest


def test_train_step_flops_by_hand(toy):
    config, traffic = toy
    k, w = config["num_classes"], config["width"]
    pixels = 16 * 32  # the stem's stride 2 at 32x64
    stem, block, head = 2 * pixels * w * 3 * 9, 2 * pixels * w * w * 9, 2 * pixels * k * w
    b, bt = traffic["source_batch"], traffic["target_batch"]
    # teacher forward + student forward and backward on [source; view], the
    # target-stats forward (no head), no translator
    want = 4 * 2 * b * (stem + block + head) + bt * (stem + block)
    assert counts.train_step_flops(config, traffic) == want


def test_reference_readings_through_the_toy_optimizer(toy):
    config, traffic = toy
    inputs = train_cell.Inputs(config, traffic, SEED, CPU)
    ref = train_cell.reference_readings(config, inputs, 2, CPU)
    named = [n for n, p in reference.build_model(config).named_parameters() if p.requires_grad]
    assert len(ref["loss"]) == 2 and all(math.isfinite(x) for x in ref["loss"])
    assert list(ref["first_update"]) == named and all(ref["change"][n] > 0 for n in named)
    assert set(ref["stats_change"]) == {f"{m}_bn.running_{s}" for m in ("stem", "block")
                                        for s in ("mean", "var")}
    # AdamW's first moment after step 1 is (1 - beta1) x the first gradient
    beta1 = traffic["recipe"]["beta1"]
    for n in named:
        assert ref["first_update"][n] == pytest.approx((1 - beta1) * ref["first_grad"][n],
                                                        rel=1e-6)
    # the family's draws come from the generators the step hands it
    again = train_cell.reference_readings(config, inputs, 2, CPU)
    assert again["loss"] == ref["loss"]
    inputs.dropout = inputs.dropout[::-1]
    assert train_cell.reference_readings(config, inputs, 1, CPU)["loss"][0] != ref["loss"][0]


def test_the_toy_optimizer_reads_the_programs_state(toy):
    _, traffic = toy
    opt = reference.optimizer(traffic["recipe"])
    p = torch.nn.Parameter(torch.randn(5, 3, generator=torch.Generator().manual_seed(3)))
    p.grad = torch.randn(5, 3, generator=torch.Generator().manual_seed(4))
    torch_opt = torch.optim.AdamW([p], lr=1e-3, betas=(traffic["recipe"]["beta1"], 0.999))
    torch_opt.step()
    q, state = torch.nn.Parameter(p.detach().clone()), {}
    q.grad = p.grad.clone()
    with torch.no_grad():
        opt.update("w", q, state, 0, 1e-3, traffic["recipe"])
    assert torch.allclose(opt.program_first_update(torch_opt.state[p]), opt.first_update(state))
    assert opt.program_first_update({"momentum_buffer": p.grad}) is None


def _stub_preset(traffic):
    from diga_tpu_torch.configs.presets import get_preset

    base = get_preset(traffic["preset"])
    return dataclasses.replace(base, train=dataclasses.replace(
        base.train, crop_hw=tuple(traffic["crop_hw"])))


def test_check_recipe_holds_the_preset_to_the_toy_keys(toy):
    _, traffic = toy
    program.check_recipe(_stub_preset(traffic), traffic)
    off = json.loads(json.dumps(traffic))
    off["recipe"]["beta1"] = 0.95
    with pytest.raises(ValueError, match="beta1"):
        program.check_recipe(_stub_preset(traffic), off)
    del off["recipe"]["optimizer"]
    with pytest.raises(ValueError, match="names no optimizer"):
        program.check_recipe(_stub_preset(traffic), off)


def _event(name, start, end, parent=None, *, device=DeviceType.CPU, id=0, seq=-1, thread=1,
           fwd_thread=0, scope=0, span=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           cpu_parent=parent, device_type=device, is_async=False,
                           sequence_nr=seq, thread=thread, fwd_thread=fwd_thread, scope=scope,
                           id=id, is_user_annotation=span)


def _toy_step_events() -> list:
    """One unit: a conv under the toy's class span, the optimizer's span,
    and the conv's backward on the autograd thread; a kernel each, 100,
    20 and 100 µs."""
    unit = _event("bench_unit", 0.0, 1000.0, span=True)
    net = _event("ToyNet", 10.0, 300.0, unit, span=True)
    conv = _event("aten::conv2d", 20.0, 100.0, net, seq=7)
    step = _event("adamw", 400.0, 500.0, unit, span=True)
    foreach = _event("aten::_foreach_add_", 410.0, 450.0, step)
    node = _event("autograd::engine::evaluate_function: ConvolutionBackward0", 600.0, 700.0,
                  seq=7, thread=2, fwd_thread=1, scope=1)
    conv_bwd = _event("aten::convolution_backward", 610.0, 690.0, node, thread=2)
    launches = [_event("cudaLaunchKernel", t, t + 5.0, op, id=i, thread=op.thread)
                for i, (t, op) in enumerate([(30.0, conv), (420.0, foreach), (620.0, conv_bwd)])]
    kernels = [_event(n, s, e, device=DeviceType.CUDA, id=i) for i, (n, s, e) in enumerate(
        [("conv_fprop", 40.0, 140.0), ("multi_tensor_apply", 430.0, 450.0),
         ("conv_dgrad", 630.0, 730.0)])]
    return [unit, net, conv, step, foreach, node, conv_bwd, *launches, *kernels]


def test_the_trace_charges_the_toy_scopes(toy):
    config, traffic = toy
    t = reduce_events(_toy_step_events(), 1, Scopes.of(config, reference.optimizer(
        traffic["recipe"])))
    assert t.components == pytest.approx({"model_fwd": 100e-6, "model_bwd": 100e-6,
                                          "optimizer_ema": 20e-6})
    assert t.busy_s == pytest.approx(220e-6) and t.window_s == pytest.approx(1000e-6)
    # under another configuration's scopes the same work is the model's of no one
    other = manifest.resolve("r101_gta5_dg", manifest.load()).config
    t = reduce_events(_toy_step_events(), 1, Scopes.of(other, reference.optimizer(
        traffic["recipe"])))
    assert t.components == pytest.approx({"misc": 200e-6, "optimizer_ema": 20e-6})
    with pytest.raises(ValueError, match="program_scope"):
        Scopes.of({"name": "no_scope"})

