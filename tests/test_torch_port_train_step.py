"""The port's warm-up and DG train steps against the jitted JAX steps, over 5 steps.

Both sides start from one JAX init (tiny depth, layers (1, 1, 1, 1), crop
32x64, f32), carried over by ``state_dict_from_jax`` and
``translator_state_dict_from_jax``; the running statistics and the
teacher are perturbed so that the EMA and the two BN trajectories matter.
Randomness is controlled as in tests/_train_step_parity_sub.py: ``beta=0``
makes the photometric view the identity, ``droprate=0`` turns dropout off,
and the CrDoMix selection is drawn in JAX with the step's own key
derivation (``steps.py:205``) and injected into the port.
``tgt_stats_forward=True``.  Each step's losses agree at rel 1e-4; after
each step the student and teacher parameters, both models' BN running
statistics and the SGD momentum agree at atol 1e-5 / rtol 1e-4 (f32 sums
in another order; over 5 steps this catches a drift of the EMA ramp, the
LR index or the order of the statistics updates).

The DG step (no translator, no CrDoMix, no RandomSharpness) is held by
the same recipe, and ``make_step_config`` of the ``dg_gta5`` and
``gta2city_selftrain`` presets against the JAX package's.

A first test holds the train-mode DeepLab forward alone: logits and the
running-statistics update against JAX ``train=True`` at ``s2b=False``.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diga_tpu.models.resnet_deeplab import DeepLabV2 as JaxDeepLabV2
from diga_tpu.models.resnet_deeplab import head_param_mask
from diga_tpu.models.translator import ImgDecoder as JaxDecoder
from diga_tpu.models.translator import ImgEncoder as JaxEncoder
from diga_tpu.ops import mixing as jax_mixing
from diga_tpu.train.optim import sgd_grouped as jax_sgd_grouped
from diga_tpu.train.schedules import poly_schedule as jax_poly
from diga_tpu.train.state import create_seg_state as jax_create_state
from diga_tpu.configs import presets as jax_presets
from diga_tpu.train.build import make_step_config as jax_make_step_config
from diga_tpu.train.steps import StepConfig as JaxStepConfig
from diga_tpu.train.steps import build_dg_step as jax_build_dg_step
from diga_tpu.train.steps import build_warmup_step as jax_build_warmup_step
from diga_tpu_torch.models.convert import state_dict_from_jax, translator_state_dict_from_jax
from diga_tpu_torch.models.resnet_deeplab import DeepLabV2
from diga_tpu_torch.models.translator import ImgDecoder, ImgEncoder
from diga_tpu_torch.train.optim import sgd_grouped
from diga_tpu_torch.train.schedules import poly_schedule
from diga_tpu_torch.train.state import create_seg_state
from diga_tpu_torch.configs import presets as port_presets
from diga_tpu_torch.train.build import make_step_config
from diga_tpu_torch.train.steps import StepConfig, build_dg_step, build_warmup_step

from _torch_port_common import LAYERS, jax_tiny_deeplab

K = 19
CROP = (32, 64)
B = 2
LR = 2.5e-4
N_STEPS = 5
ATOL, RTOL = 1e-5, 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(ours: torch.Tensor, ref, name):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL,
                               err_msg=name)


# ---------------------------------------------------------------------------
# the train-mode forward
# ---------------------------------------------------------------------------

def test_train_mode_forward_and_running_stats_match_jax():
    _, params, stats = jax_tiny_deeplab(seed=7)
    jmodel = JaxDeepLabV2(num_classes=K, layers=LAYERS, s2b=False, droprate=0.0)
    x = np.random.default_rng(8).normal(size=(2, 33, 65, 3)).astype(np.float32)
    (_, _, ref_logits, _), mut = jmodel.apply({"params": params, "batch_stats": stats},
                                              jnp.asarray(x), train=True,
                                              mutable=["batch_stats"])
    model = DeepLabV2(num_classes=K, layers=LAYERS, droprate=0.0)
    model.load_state_dict(state_dict_from_jax(params, stats, LAYERS), strict=True)
    model.train()
    with torch.no_grad():
        logits = model(torch.from_numpy(x).permute(0, 3, 1, 2))[2].permute(0, 2, 3, 1)
    ref_logits = np.asarray(ref_logits)
    np.testing.assert_allclose(logits.numpy(), ref_logits,
                               atol=1e-4 * np.abs(ref_logits).max(), rtol=0)
    ref_sd = state_dict_from_jax(params, _np(mut["batch_stats"]), LAYERS)
    for k, v in model.named_buffers():
        if "running" in k:
            _close(v, ref_sd[k], k)
    # the affine of every BN is frozen, the rest trains
    frozen = {k for k, p in model.named_parameters() if not p.requires_grad}
    assert frozen and all(".bn" in k or "downsample.1" in k or k.startswith("layer0.1")
                          for k in frozen)


# ---------------------------------------------------------------------------
# 5 warm-up steps
# ---------------------------------------------------------------------------

def _jax_setup(stage="warmup"):
    model = JaxDeepLabV2(num_classes=K, layers=LAYERS, droprate=0.0, s2b=False)
    k = jax.random.PRNGKey(3)
    x = jnp.zeros((1, *CROP, 3), jnp.float32)
    variables = model.init({"params": k, "dropout": k}, x, train=False)
    opt = jax_sgd_grouped(jax_poly(LR, 1000), head_param_mask(variables["params"]),
                          momentum=0.9, weight_decay=5e-4)
    enc, dec = JaxEncoder(dim=8, n_downsample=2, n_res=1), JaxDecoder(dim=32, n_upsample=2, n_res=1)
    enc_p = enc.init(k, x)["params"]
    dec_p = dec.init(k, enc.apply({"params": enc_p}, x))["params"]
    frozen = {"enc_s": enc_p, "dec_s2t": dec_p}

    def translator_apply(fz, img):
        return dec.apply({"params": fz["dec_s2t"]}, enc.apply({"params": fz["enc_s"]}, img))

    state = jax_create_state(model, opt, k, CROP, frozen=frozen)
    # the frozen BN biases at +4 keep every backbone ReLU input away from
    # its kink: an f32 rounding difference between the two sides must not
    # flip a ReLU mask (one flipped element moves the gradients upstream of
    # it by up to 5%, so the momentum could not be compared elementwise)
    state = state.replace(params=jax.tree_util.tree_map_with_path(
        lambda path, a: np.full_like(a, 4.0)
        if "frozen_bn" in jax.tree_util.keystr(path) and jax.tree_util.keystr(path).endswith("['bias']")
        else np.asarray(a), state.params))
    rr = np.random.default_rng(11)
    noisy = lambda tree, s: jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rr.normal(size=a.shape).astype(np.float32) * s, tree)
    state = state.replace(
        batch_stats=jax.tree_util.tree_map(np.abs, noisy(state.batch_stats, 0.01)),
        teacher_batch_stats=jax.tree_util.tree_map(np.abs, noisy(state.batch_stats, 0.01)),
        teacher_params=noisy(state.params, 0.01))
    cfg = JaxStepConfig(crop_hw=CROP, beta=0.0, tgt_stats_forward=True,
                        with_sharpness=stage != "dg")
    if stage == "dg":
        step = jax.jit(jax_build_dg_step(model, opt, cfg))
    else:
        step = jax.jit(jax_build_warmup_step(model, translator_apply, opt, cfg))
    return state, step


def _port_setup(jstate, stage="warmup"):
    student = DeepLabV2(num_classes=K, layers=LAYERS, droprate=0.0)
    student.load_state_dict(state_dict_from_jax(_np(jstate.params), _np(jstate.batch_stats),
                                                LAYERS), strict=True)
    sds = translator_state_dict_from_jax(_np(jstate.frozen["enc_s"]), _np(jstate.frozen["dec_s2t"]))
    enc, dec = ImgEncoder(dim=8, n_downsample=2, n_res=1), ImgDecoder(dim=32, n_upsample=2, n_res=1)
    enc.load_state_dict(sds["enc_s"], strict=True)
    dec.load_state_dict(sds["dec_s2t"], strict=True)
    opt = sgd_grouped(student, LR, momentum=0.9, weight_decay=5e-4, head_mult=10.0)
    translator = None if stage == "dg" else torch.nn.ModuleDict({"enc_s": enc, "dec_s2t": dec})
    state = create_seg_state(student, opt, seed=0, translator=translator)
    state.teacher.load_state_dict(state_dict_from_jax(
        _np(jstate.teacher_params), _np(jstate.teacher_batch_stats), LAYERS), strict=True)
    cfg = StepConfig(num_classes=K, crop_hw=CROP, beta=0.0, tgt_stats_forward=True,
                     with_sharpness=stage != "dg", compute_dtype=torch.float32)
    build = build_dg_step if stage == "dg" else build_warmup_step
    return state, build(cfg, poly_schedule(LR, 1000))


def _batch(i):
    rr = np.random.default_rng(100 + i)
    s_lbl = rr.choice(rr.choice(K, size=7, replace=False), size=(B, *CROP)).astype(np.int32)
    s_lbl[:, :4] = 255  # the ignore path
    return {"s_img": (rr.normal(size=(B, *CROP, 3)) * 0.5).astype(np.float32),
            "s_lbl": s_lbl,
            "t_img": (rr.normal(size=(B, *CROP, 3)) * 0.5).astype(np.float32)}


def _snapshot_jax(jstate):
    params = state_dict_from_jax(_np(jstate.params), _np(jstate.batch_stats), LAYERS)
    teacher = state_dict_from_jax(_np(jstate.teacher_params), _np(jstate.teacher_batch_stats),
                                  LAYERS)
    mu = state_dict_from_jax(_np(jstate.opt_state["mu"]), _np(jstate.batch_stats), LAYERS)
    return {"student": params, "teacher": teacher, "mu": mu}


def _snapshot_port(state):
    mu = {}
    for k, p in state.student.named_parameters():
        if p.requires_grad:
            mu[k] = state.optimizer.state[p]["momentum_buffer"].clone()
    return {"student": copy.deepcopy(state.student.state_dict()),
            "teacher": copy.deepcopy(state.teacher.state_dict()), "mu": mu}


def _run(stage):
    jstate, jstep = _jax_setup(stage)
    state, step = _port_setup(jstate, stage)
    out = []
    for i in range(N_STEPS):
        batch = _batch(i)
        kw = {}
        if stage == "warmup":
            _, _, k_mix, _, _, _ = jax.random.split(jstate.rng, 6)
            kw["selection"] = torch.from_numpy(np.array(
                jax_mixing.sample_half_classes(jnp.asarray(batch["s_lbl"]), k_mix, K)))
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, **kw)
        out.append({"jax": {k: float(v) for k, v in jmetrics.items()},
                    "port": {k: float(v) for k, v in metrics.items()},
                    "jax_state": _snapshot_jax(jstate), "port_state": _snapshot_port(state)})
    assert state.step == int(jstate.step) == N_STEPS
    return out


@pytest.fixture(scope="module")
def trajectories():
    return _run("warmup")


@pytest.fixture(scope="module")
def dg_trajectories():
    return _run("dg")


@pytest.mark.parametrize("metric", ["loss", "loss_semseg", "loss_distil"])
def test_losses_match_every_step(trajectories, metric):
    for i, t in enumerate(trajectories):
        assert t["port"][metric] == pytest.approx(t["jax"][metric], rel=1e-4), (i, metric)


@pytest.mark.parametrize("role", ["student", "teacher"])
def test_parameters_match_every_step(trajectories, role):
    moved = False
    for i, t in enumerate(trajectories):
        ours, ref = t["port_state"][role], t["jax_state"][role]
        for k, v in ours.items():
            if "running" not in k and not k.endswith("num_batches_tracked"):
                _close(v, ref[k], f"step {i} {role} {k}")
        moved |= not torch.equal(trajectories[0]["port_state"][role]["final.head.1.weight"],
                                 t["port_state"][role]["final.head.1.weight"])
    assert moved, f"{role} parameters never moved"


@pytest.mark.parametrize("role", ["student", "teacher"])
def test_running_stats_match_every_step(trajectories, role):
    for i, t in enumerate(trajectories):
        ours, ref = t["port_state"][role], t["jax_state"][role]
        keys = [k for k in ours if "running" in k]
        assert keys
        for k in keys:
            _close(ours[k], ref[k], f"step {i} {role} {k}")


def test_sgd_momentum_matches_every_step(trajectories):
    for i, t in enumerate(trajectories):
        ours, ref = t["port_state"]["mu"], t["jax_state"]["mu"]
        assert ours and "layer0.1.weight" not in ours  # the BN affine is out of the optimizer
        for k, v in ours.items():
            _close(v, ref[k], f"step {i} momentum {k}")


@pytest.mark.parametrize("tgt_stats_forward", [False, True])
def test_target_stats_forward_moves_only_the_students_running_stats(tgt_stats_forward):
    """With the target-stats forward off the step needs no target batch,
    and its BN running statistics are those of [source; mix] alone."""
    torch.manual_seed(0)
    model_sd = DeepLabV2(num_classes=K, layers=LAYERS, droprate=0.0).state_dict()
    enc, dec = ImgEncoder(dim=8, n_res=1), ImgDecoder(dim=32, n_res=1)
    results = {}
    for tsf in (False, tgt_stats_forward):
        student = DeepLabV2(num_classes=K, layers=LAYERS, droprate=0.0)
        student.load_state_dict(model_sd)
        state = create_seg_state(student, sgd_grouped(student, LR), seed=0,
                                 translator=torch.nn.ModuleDict({"enc_s": enc, "dec_s2t": dec}))
        step = build_warmup_step(StepConfig(num_classes=K, crop_hw=CROP, beta=0.4,
                                            tgt_stats_forward=tsf, compute_dtype=torch.float32),
                                 poly_schedule(LR, 1000))
        batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
        if not tsf:
            del batch["t_img"]
        metrics = step(state, batch)
        results[tsf] = (metrics, state.student.state_dict())
    (m_off, sd_off), (m, sd) = results[False], results[tgt_stats_forward]
    assert all(torch.equal(m_off[k], m[k]) for k in m)
    stats_equal = all(torch.equal(sd_off[k], sd[k]) for k in sd if "running" in k)
    assert stats_equal == (not tgt_stats_forward)
    assert all(torch.equal(sd_off[k], sd[k]) for k in sd if "running" not in k
               and not k.endswith("num_batches_tracked"))


# ---------------------------------------------------------------------------
# 5 DG steps, and the stage defaults of the step config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["metrics", "student", "teacher", "running_stats", "momentum"])
def test_dg_step_matches_jax_every_step(dg_trajectories, what):
    for i, t in enumerate(dg_trajectories):
        if what == "metrics":
            assert set(t["port"]) == set(t["jax"]) == {"loss", "loss_semseg", "loss_distil"}
            for k, v in t["jax"].items():
                assert t["port"][k] == pytest.approx(v, rel=1e-4), (i, k)
            continue
        roles = {"momentum": ["mu"], "running_stats": ["student", "teacher"]}.get(what, [what])
        for role in roles:
            ours, ref = t["port_state"][role], t["jax_state"][role]
            keys = [k for k in ours if not k.endswith("num_batches_tracked")
                    and (role == "mu" or ("running" in k) == (what == "running_stats"))]
            assert keys
            for k in keys:
                _close(ours[k], ref[k], f"DG step {i} {role} {what} {k}")


@pytest.mark.parametrize("preset", ["dg_gta5", "gta2city_selftrain", "gta2city_warmup"])
def test_step_config_stage_defaults_match_jax(preset):
    ours = make_step_config(port_presets.get_preset(preset))
    ref = jax_make_step_config(jax_presets.get_preset(preset))
    for field in ("with_sharpness", "tgt_stats_forward", "beta", "lambda_distil", "lambda_seg",
                  "crop_hw", "num_classes", "p_jitter"):
        assert getattr(ours, field) == getattr(ref, field), field
    assert ours.with_sharpness == (preset != "dg_gta5")
    assert ours.tgt_stats_forward == (preset != "gta2city_selftrain")
