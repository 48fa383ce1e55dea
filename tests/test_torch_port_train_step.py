"""The port's warm-up and DG train steps against the jitted JAX steps, over 5 steps.

The recipe lives in tests/_torch_port_steps.py, which the SYNTHIA and
kornia parities share.  Both sides start from one JAX init (tiny depth,
layers (1, 1, 1, 1), crop 32x64, f32), carried over by ``state_dict_from_jax`` and
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

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diga_tpu.models.resnet_deeplab import DeepLabV2 as JaxDeepLabV2
from diga_tpu.configs import presets as jax_presets
from diga_tpu.train.build import make_step_config as jax_make_step_config
from diga_tpu_torch.models.convert import state_dict_from_jax
from diga_tpu_torch.models.resnet_deeplab import DeepLabV2
from diga_tpu_torch.models.translator import ImgDecoder, ImgEncoder
from diga_tpu_torch.train.optim import sgd_grouped
from diga_tpu_torch.train.schedules import poly_schedule
from diga_tpu_torch.train.state import create_seg_state
from diga_tpu_torch.configs import presets as port_presets
from diga_tpu_torch.train.build import make_step_config
from diga_tpu_torch.train.steps import StepConfig, build_warmup_step

import _torch_port_steps as steps
from _torch_port_common import LAYERS, jax_tiny_deeplab

K = 19
CROP = (32, 64)
LR = 2.5e-4
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
# 5 warm-up steps (the recipe: tests/_torch_port_steps.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trajectories():
    return steps.run_steps("warmup")


@pytest.fixture(scope="module")
def dg_trajectories():
    return steps.run_steps("dg")


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
        batch = {k: torch.from_numpy(v) for k, v in steps.make_batch(0, K).items()}
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

@pytest.mark.parametrize("what", steps.WHAT)
def test_dg_step_matches_jax_every_step(dg_trajectories, what):
    steps.check(dg_trajectories, what)


@pytest.mark.parametrize("preset", ["dg_gta5", "gta2city_selftrain", "gta2city_warmup"])
def test_step_config_stage_defaults_match_jax(preset):
    ours = make_step_config(port_presets.get_preset(preset))
    ref = jax_make_step_config(jax_presets.get_preset(preset))
    for field in ("with_sharpness", "tgt_stats_forward", "beta", "lambda_distil", "lambda_seg",
                  "crop_hw", "num_classes", "p_jitter"):
        assert getattr(ours, field) == getattr(ref, field), field
    assert ours.with_sharpness == (preset != "dg_gta5")
    assert ours.tgt_stats_forward == (preset != "gta2city_selftrain")
