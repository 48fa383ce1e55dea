"""SegFormer MiT with DAFormer's head (``models/mit_daformer.py``) and its
AdamW warm-up, held to the benchmark's plain reference on the CPU.

The reference (``benchmark/reference/families/mit_daformer.py``,
``optimizers/adamw.py``) is plain f32 PyTorch that imports nothing of the
port.  At a tiny size (2 blocks a stage, widths 32/64/160/256, heads
1/2/5/8, MiT-B5's SR ratios, a 64-wide head, crop 32x64) and on the
benchmark's seeded random weights:
  * the forward's four outputs, ``bn_stats_forward``'s BN statistics, and
    the stochastic-depth and dropout draws, all from the one generator;
  * three AdamW warm-up steps of the port's ``build_warmup_step`` (through
    ``build_experiment``, as the benchmark drives it) against the
    reference's ``run_steps``, in f32: the losses, each leaf's first
    moment, each leaf's change and each BN statistic's change;
  * the two-scale eval;
  * a saved and restored state continues bit for bit;
  * the spans of one eager forward, the optimizer's groups and schedule,
    and the refusals.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch

from benchmark.harness import compare, manifest, program, train_cell
from benchmark.harness.manifest import Cell
from benchmark.harness.weights import seeded_state, shapes_of
from benchmark.reference import build_model, build_translator
from benchmark.reference.evaluate import two_scale_logits as ref_two_scale_logits
from benchmark.reference.optimizers import adamw as ref_adamw
from benchmark.reference.train import run_steps
from diga_tpu_torch.configs import presets
from diga_tpu_torch.eval.evaluator import two_scale_logits
from diga_tpu_torch.models import mit_daformer
from diga_tpu_torch.train import optim, schedules
from diga_tpu_torch.train.build import build_eval, build_experiment, make_schedule
from diga_tpu_torch.train.state import reference_state_dict
from diga_tpu_torch.utils import profiling

CPU = torch.device("cpu")
SEED = 2**31 + 99
CELL = "mitb5_gta2city_warmup"
TINY = {"embed_dims": (32, 64, 160, 256), "num_heads": (1, 2, 5, 8), "depths": (2, 2, 2, 2),
        "sr_ratios": (8, 4, 2, 1), "mlp_ratio": 4, "drop_path_rate": 0.1, "head_channels": 64,
        "aspp_dilations": (1, 6, 12, 18)}


@pytest.fixture(scope="module", autouse=True)
def _tiny_arch():
    """One intra-op thread (the suite runs several workers on one host), and
    the tiny arch and presets registered for the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mit_daformer.ARCHS["tiny"] = TINY
    base = presets.get_preset("gta2city_warmup_mitb5")
    presets.PRESETS["tiny_mit"] = dataclasses.replace(
        base, name="tiny_mit",
        train=dataclasses.replace(base.train, compute_dtype="float32", crop_hw=(32, 64)),
        eval=presets.EvalConfig(out_hw=(64, 128), ds_hw=(32, 64)),
        extra={**base.extra, "mit_arch": "tiny"})
    yield
    presets.PRESETS.pop("tiny_mit")
    mit_daformer.ARCHS.pop("tiny")
    torch.set_num_threads(threads)


def tiny_cell() -> Cell:
    """The benchmark's cell with the tiny arch, crop and an f32 preset."""
    cell = manifest.resolve(CELL, manifest.load())
    cfg, tr = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
    cfg["mit"].update(embed_dims=list(TINY["embed_dims"]), depths=list(TINY["depths"]))
    cfg["head"]["channels"] = TINY["head_channels"]
    cfg["program_extra"] = {"model": "mit_daformer", "mit_arch": "tiny"}
    tr.update(crop_hw=[32, 64], label_block=8, preset="tiny_mit")
    tr["recipe"]["crop_hw"] = [32, 64]
    return Cell(CELL, cfg, tr, 1, cell.end_to_end, cell.per_layer)


def _pair(seed: int = 3):
    """(port, reference) tiny models on the same seeded weights."""
    cfg = tiny_cell().config
    ref = build_model(cfg)
    weights = seeded_state(shapes_of(ref), seed, CPU)
    ref.load_state_dict(weights)
    port = mit_daformer.MiTDAFormer(19, TINY)
    port.load_state_dict(weights)
    return port, ref


def _image(b: int = 4, hw=(32, 64), seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, 3, *hw), generator=g) * 0.5


def _close(a: torch.Tensor, b: torch.Tensor, rel: float) -> None:
    """Within ``rel`` of the reference's largest magnitude."""
    a, b = a.detach().float(), b.detach()
    scale, err = float(b.abs().max()), float((a - b).abs().max())
    assert err <= rel * scale, (err, scale)


# f32 on one thread: the port's channels_last convs and its SDPA math path
# against the reference's NCHW convs and written-out attention round
# differently, a few float32 ulps a layer over 8 blocks and the head
F32_REL = 2e-5


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_matches_the_reference(train):
    port, ref = _pair()
    port.train(train)
    ref.train(train)
    port.channel_dropout.generator = torch.Generator().manual_seed(7)
    ref.set_generator(torch.Generator().manual_seed(7))
    x = _image()
    with torch.no_grad():
        ours = port(x.contiguous(memory_format=torch.channels_last))
        want = ref(x)
    for a, b in zip(ours, want):
        assert a.shape == b.shape
        _close(a, b, F32_REL)
    assert tuple(ours[2].shape) == (4, 19, 8, 16)  # logits at 1/4 of the input


def test_bn_stats_forward_matches_the_reference():
    port, ref = _pair()
    port.train()
    ref.train()
    gp, gr = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    port.channel_dropout.generator = gp
    ref.set_generator(gr)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    with torch.no_grad():
        port.bn_stats_forward(_image(seed=1))
        ref.stats_forward(_image(seed=1))
    ours, want = port.state_dict(), ref.state_dict()
    moved = [k for k in ours if k.endswith(("running_mean", "running_var"))]
    assert moved and all(k.startswith("decode_head.") for k in moved)  # only the head has BN
    for k in moved:
        assert not torch.equal(ours[k], before[k]), k
        _close(ours[k], want[k], F32_REL)
    # the blocks drew, the head's dropout did not: both sides alike
    assert torch.equal(gp.get_state(), gr.get_state())


def test_every_draw_comes_from_the_one_generator_in_order():
    port, _ = _pair()
    port.train()
    gen = torch.Generator().manual_seed(5)
    port.channel_dropout.generator = gen
    b = 4
    with torch.no_grad():
        port(_image(b))
    # replay the draws the module docstring lists on a second generator
    twin = torch.Generator().manual_seed(5)
    rates = torch.linspace(0, TINY["drop_path_rate"], sum(TINY["depths"])).tolist()
    for r in rates:
        if r > 0:
            torch.rand((b, 1, 1), generator=twin)
            torch.rand((b, 1, 1), generator=twin)
    torch.rand((b, TINY["head_channels"], 1, 1), generator=twin)
    assert torch.equal(gen.get_state(), twin.get_state())
    # and nothing else draws: the default generator is untouched
    state = torch.random.get_rng_state()
    with torch.no_grad():
        port(_image(b))
    assert torch.equal(state, torch.random.get_rng_state())


def test_the_preset_holds_the_benchmarks_recipe():
    cell = manifest.resolve(CELL, manifest.load())
    cfg = program.experiment(cell.config, cell.traffic)
    program.check_recipe(cfg, cell.traffic)
    mine, base = presets.get_preset("gta2city_warmup_mitb5"), presets.get_preset("gta2city_warmup")
    assert mine.data == base.data and mine.eval == base.eval
    changed = {f.name for f in dataclasses.fields(mine.train)
               if getattr(mine.train, f.name) != getattr(base.train, f.name)}
    assert changed == {"optimizer", "learning_rate", "weight_decay", "num_steps", "power",
                       "lr_warmup", "lr_warmup_ratio"}
    assert mine.extra == {"model": "mit_daformer", "mit_arch": "b5", "rgb_input": True}


@pytest.mark.parametrize("k", [0, 1, 2, 749, 1499, 1500, 20_000, 39_999])
def test_schedule_is_mmcv_linear_warmup_over_poly(k):
    cell = manifest.resolve(CELL, manifest.load())
    ours = make_schedule(presets.get_preset("gta2city_warmup_mitb5"))(k)
    # f32 against the reference's float64 arithmetic: a few f32 ulps of the
    # value, or of the base LR where 1 - k / 40000 cancels near the end
    assert ours == pytest.approx(ref_adamw.lr(cell.traffic["recipe"], k), rel=1e-6,
                                 abs=6e-5 * 2**-22)


def test_the_warmup_factor_keeps_its_precision_in_f32():
    fn = schedules.poly_linear_warmup_schedule(6e-5, 40_000, 1500, 1e-6)
    # 1 - (1 - 1e-6) in float32 is 1.013e-6: the stable form keeps 1e-6
    assert fn(0) == pytest.approx(6e-11, rel=1e-6)
    assert np.float32(1.0) - np.float32(1.0 - 1e-6) != np.float32(1e-6)


def test_adamw_groups_follow_daformers_custom_keys():
    port, ref = _pair()
    opt = optim.adamw_grouped(port, 6e-5, 0.01, head_mult=10.0)
    group_of = {id(p): g for g in opt.param_groups for p in g["params"]}
    names = dict(port.named_parameters())
    assert len(group_of) == len(names)
    for name, p in names.items():
        g = group_of[id(p)]
        assert g["weight_decay"] == pytest.approx(0.01 * ref_adamw.decay_mult(name)), name
        assert g["lr_mult"] == (10.0 if ref.head_param(name) else 1.0), name
    assert group_of[id(names["backbone.block1.0.norm1.weight"])]["weight_decay"] == 0.0
    assert group_of[id(names["backbone.patch_embed2.norm.bias"])]["weight_decay"] == 0.0
    head_bn = names["decode_head.fuse_layer.bottleneck.bn.weight"]
    assert group_of[id(head_bn)]["weight_decay"] == 0.01  # `head` is tried before `norm`
    assert group_of[id(names["backbone.block3.1.attn.kv.weight"])]["weight_decay"] == 0.01


@pytest.fixture(scope="module")
def three_steps():
    """The first 3 steps of the program (through ``build_experiment``) and of
    the reference (``run_steps``) from the same weights, batches and draws:
    (program readings, reference readings, each side's change of every
    trainable leaf)."""
    cell = tiny_cell()
    inputs = train_cell.Inputs(cell.config, cell.traffic, SEED, CPU)
    state, step = program.build_train(cell.config, cell.traffic, CPU)
    assert isinstance(state.optimizer, torch.optim.AdamW)
    train_cell.load_program(state, inputs)
    prog = train_cell.first_steps(state, step, inputs, 3)
    model = build_model(cell.config)
    model.load_state_dict(inputs.weights)
    translator = build_translator(cell.config)
    translator.load_state_dict(inputs.translator)
    translator.requires_grad_(False).eval()
    ref = run_steps(model, translator, cell.traffic["recipe"], [inputs.batch(i) for i in range(3)],
                    inputs.draws[:3], inputs.dropout)
    delta = {side: {k: p.detach() - inputs.weights[k] for k, p in m.named_parameters()}
             for side, m in (("program", state.student), ("reference", model))}
    return prog, ref, delta


def test_three_adamw_steps_match_the_reference(three_steps):
    prog, ref, delta = three_steps
    # the loss: f32 rounding of the forwards, a few ulps of the sum
    assert prog["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    keep = compare.moving_leaves(ref)
    assert len(keep) > 0.9 * len(ref["first_update"])
    # the first moment is 0.1 x the first gradient: the backward's f32
    # rounding relative to the leaf (over 4 seeds the worst read 1.1e-4,
    # a LayerNorm bias in stage 1)
    for k in keep:
        assert prog["first_update"][k] == pytest.approx(ref["first_update"][k], rel=1e-3), k
    # each leaf's change over 3 steps.  AdamW moves every element by about
    # the LR whatever its gradient's size, so an element whose gradient is
    # mostly cancellation carries its f32 rounding at full size: a bias's
    # change read up to 4.4e-3 over 4 seeds.  The keys' half of
    # ``attn.kv.bias`` has no gradient at all (the softmax over keys is
    # invariant to it): it moves with the sign of the rounding noise on
    # either side and is left out.
    for k in keep:
        a, b = delta["program"][k], delta["reference"][k]
        if k.endswith("attn.kv.bias"):
            a, b = a[a.shape[0] // 2:], b[b.shape[0] // 2:]
        assert float(a.norm()) == pytest.approx(float(b.norm()), rel=1e-2), k
    assert compare.train_readings(prog, ref)["change_median_gap"] <= 1e-4
    # BN statistics: f32 rounding of the head's batch moments
    for k, v in ref["stats_change"].items():
        assert prog["stats_change"][k] == pytest.approx(v, rel=1e-5), k


def test_two_scale_eval_matches_the_reference():
    cfg = presets.get_preset("tiny_mit")
    apply_fn, model = build_eval(cfg, None, CPU)
    ref = build_model(tiny_cell().config)
    ref.load_state_dict({k: v for k, v in model.state_dict().items()}, strict=True)
    g = torch.Generator().manual_seed(4)
    image = torch.randn((1, 64, 128, 3), generator=g) * 0.5
    ours = two_scale_logits(apply_fn, image, (64, 128), (32, 64))
    want = ref_two_scale_logits(ref, image, (64, 128), (32, 64), rgb_input=True)
    _close(ours, want, F32_REL)
    assert torch.equal(ours.argmax(-1), want.argmax(-1))


def test_a_restored_state_continues_bit_for_bit():
    from diga_tpu_torch.utils.synth import synth_batch

    cfg = presets.get_preset("tiny_mit")
    state, step, _ = build_experiment(cfg, CPU)
    batches = [synth_batch(cfg, "cpu", seed=i) for i in range(3)]
    step(state, batches[0])
    saved = copy.deepcopy(state.state_dict())
    assert {"exp_avg", "exp_avg_sq"} <= set(next(iter(saved["state"]["optimizer"]["state"]
                                                       .values())))
    for b in batches[1:]:
        step(state, b)
    # the role state_dicts leave out BN's batch counters, which a BN with a
    # momentum never reads
    straight = {k: v.clone() for k, v in reference_state_dict(state.student).items()}
    fresh, step2, _ = build_experiment(cfg, CPU)
    fresh.load_state_dict(saved)
    for b in batches[1:]:
        step2(fresh, b)
    again = reference_state_dict(fresh.student)
    assert all(torch.equal(straight[k], again[k]) for k in straight)
    pairs = [(p, q) for g, h in zip(state.optimizer.param_groups, fresh.optimizer.param_groups)
             for p, q in zip(g["params"], h["params"])]
    for p, q in pairs:
        a, b = state.optimizer.state[p], fresh.optimizer.state[q]
        assert torch.equal(a["exp_avg"], b["exp_avg"]) and torch.equal(a["exp_avg_sq"],
                                                                       b["exp_avg_sq"])
    assert fresh.step == state.step == 3


def test_one_eager_forward_spans():
    port, _ = _pair()
    with profiling.recording() as rec, torch.no_grad():
        port(_image(2))
    names = [s[0] for s in profiling.drain(rec)[0]]
    blocks = sum(TINY["depths"])
    assert {n: names.count(n) for n in ("patch_embed", "mit_attn", "mix_ffn", "daformer_head")} \
        == {"patch_embed": 4, "mit_attn": blocks, "mix_ffn": blocks, "daformer_head": 1}
    assert sum(mit_daformer.B5["depths"]) == 52  # 4, 52, 52 and 1 at B5's depths


def test_the_step_names_its_optimizer_span_and_components():
    from diga_tpu_torch.utils.synth import synth_batch

    cfg = presets.get_preset("tiny_mit")
    state, step, _ = build_experiment(cfg, CPU)
    with profiling.recording() as rec:
        step(state, synth_batch(cfg, "cpu", seed=0))
    names = {s[0] for s in profiling.drain(rec)[0]}
    assert {"train_step", "MiTDAFormer", "adamw", "mit_attn", "ImgEncoder"} <= names
    assert "sgd" not in names
    dc = profiling.default_component
    assert dc("train_step/MiTDAFormer/mit_attn", False) == "model_fwd"
    assert dc("train_step/MiTDAFormer/daformer_head", True) == "model_bwd"
    assert dc("train_step/adamw", False) == "optimizer_ema"


def test_refusals():
    cfg = presets.get_preset("tiny_mit")
    with pytest.raises(NotImplementedError, match="no MiT ImageNet weights"):
        build_experiment(cfg, CPU, pretrained_backbone="mit_b5.pth")
    bad = dataclasses.replace(cfg, extra={**cfg.extra, "mit_arch": "b9"})
    with pytest.raises(ValueError, match="mit_arch"):
        build_experiment(bad, CPU)


def test_attention_calls_and_their_readers():
    from benchmark.harness import attention
    from benchmark.harness.peaks import TABLE
    from benchmark.harness.trace import Trace

    config, traffic = attention.read_cell_files("mitb5_daformer", "gta2city_warmup_mitb5_batch")
    calls = attention.step_calls(config, traffic)
    # teacher + student forwards at batch 6, the stats forward at 3; one backward
    assert (len(calls["forward"]), len(calls["backward"])) == (3 * 52, 52)
    assert calls["backward"][0] == (6, 1, 28672, 448, 64)   # stage 1: 128x224 to 16x28
    assert calls["backward"][-1] == (6, 8, 448, 448, 64)    # stage 4, no reduction
    assert calls["forward"][-1] == (3, 8, 448, 448, 64)
    peaks = TABLE["H100"]
    least = sum(attention.least_s(c, k == "backward", 2, peaks) for k, cs in calls.items()
                for c in cs)
    # a stage-1 forward is compute-bound: 4·6·28672·448·64 FLOPs at 989 TFLOP/s
    assert attention.least_s((6, 1, 28672, 448, 64), False, 2, peaks) == pytest.approx(
        4 * 6 * 28672 * 448 * 64 / 989e12)

    def trace(n_fwd, n_bwd, units=2, us=10.0):
        ops = ([("void pytorch_flash::flash_fwd_kernel<T>(P)", 0.0, us)] * n_fwd
               + [("void pytorch_flash::flash_bwd_dq_dk_dv_loop_seqk_parallel_kernel<T>(P)",
                   0.0, 2 * us)] * n_bwd
               + [("void pytorch_flash::flash_bwd_convert_dq_kernel<T>(P)", 0.0, 1.0)] * n_bwd
               + [("void softmax_warp_forward<float>(...)", 0.0, 5.0)])
        return Trace(units, 1.0, 0.9, ops, {}, {}, [], [])

    t = trace(156 * 2, 52 * 2)
    busy_s = (156 * 2 * 10.0 + 52 * 2 * 21.0) / 1e6
    assert attention.device_s(t) == pytest.approx(busy_s)
    assert attention.roofline(t, calls, 2, peaks) == pytest.approx(100 * 2 * least / busy_s)
    assert attention.roofline(trace(156 * 2 - 1, 52 * 2), calls, 2, peaks) is None
    assert attention.device_s(trace(0, 0)) is None
    # the cell's two readers, as the harness loads them
    from benchmark.harness.metrics import Context, load_reader

    ctx = Context(trace=t, units_per_s=3.0, unit_flops=1, peaks=peaks, kernel_sites={},
                  elem_bytes=2)
    assert load_reader("attn_device_ms.train")(ctx) == pytest.approx(1e3 * busy_s / 2)
    assert load_reader("attn_roofline.train")(ctx) == pytest.approx(100 * 2 * least / busy_s)
    ctx.trace = trace(0, 0)
    assert load_reader("attn_device_ms.train")(ctx) is None
    assert load_reader("attn_roofline.train")(ctx) is None
