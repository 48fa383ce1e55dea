"""The port's warm-up ops against their diga_tpu twins on the same inputs.

Cross entropy, EMA, CrDoMix and its masks, the ``diga`` photometric chain
(the JAX draws, derived here from the same key split as
``diga_tpu/ops/photometric.py:126-163``, injected into the port), the
gaussian blur, the LR schedules and the grouped SGD.  Inputs come from
numpy seeds; the JAX side runs on the CPU.  Tolerances: exact where the
arithmetic is the same elementwise ops in the same order (masks, mixing),
1e-6 for f32 reductions (CE, schedules), 1e-5 for the photometric chain
(HSV round trip, blur), atol 1e-7 on parameters for the optimizer (updates
of O(lr · grad)).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diga_tpu.models.resnet_deeplab import head_param_mask
from diga_tpu.ops import ema as jax_ema
from diga_tpu.ops import losses as jax_losses
from diga_tpu.ops import mixing as jax_mixing
from diga_tpu.ops import photometric as jax_photo
from diga_tpu.train import optim as jax_optim
from diga_tpu.train import schedules as jax_sched
from diga_tpu_torch.models.convert import state_dict_from_jax
from diga_tpu_torch.models.resnet_deeplab import DeepLabV2
from diga_tpu_torch.ops import ema, mixing
from diga_tpu_torch.ops import photometric as P
from diga_tpu_torch.ops.losses import cross_entropy2d
from diga_tpu_torch.train import optim, schedules

from _torch_port_common import LAYERS, jax_tiny_deeplab

K = 19


def _labels(shape, seed, n_classes=K):
    rng = np.random.default_rng(seed)
    # a few classes per image, as real label maps have, plus ignore pixels
    lbl = rng.choice(rng.choice(n_classes, size=6, replace=False), size=shape).astype(np.int32)
    lbl[:, :2] = 255
    return lbl


def _port_model(params, stats) -> DeepLabV2:
    model = DeepLabV2(num_classes=K, layers=LAYERS)
    model.load_state_dict(state_dict_from_jax(params, stats, LAYERS), strict=True)
    return model


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_cross_entropy_divides_by_all_pixels():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(2, 9, 11, K)) * 3).astype(np.float32)
    labels = _labels((2, 9, 11), seed=1)
    lt = torch.from_numpy(logits).requires_grad_(True)
    ce = cross_entropy2d(lt, torch.from_numpy(labels))
    ce.backward()
    ce = ce.detach()
    ref, ref_grad = jax.value_and_grad(jax_losses.cross_entropy2d)(
        jnp.asarray(logits), jnp.asarray(labels))
    assert float(ce) == pytest.approx(float(ref), rel=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(ref_grad), atol=1e-7, rtol=1e-5)
    # the valid-count mean is larger: 255 pixels count in the divisor
    valid = torch.nn.functional.cross_entropy(
        lt.detach().permute(0, 3, 1, 2), torch.from_numpy(labels).long(), ignore_index=255)
    assert float(valid) > float(ce)


# ---------------------------------------------------------------------------
# EMA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 4, 5000])
def test_ema_over_params_only(step):
    _, p_stu, s_stu = jax_tiny_deeplab(seed=1)
    _, p_tea, s_tea = jax_tiny_deeplab(seed=2)
    student, teacher = _port_model(p_stu, s_stu), _port_model(p_tea, s_tea)
    buffers_before = {k: v.clone() for k, v in teacher.named_buffers()}
    alpha = ema.ema_alpha(step)
    ref_alpha = float(jax_ema.ema_alpha(jnp.asarray(step, jnp.int32)))
    assert alpha == ref_alpha
    ema.ema_update(teacher, student, alpha)
    ref = jax_ema.ema_update(p_tea, p_stu, jnp.float32(ref_alpha))
    ref_sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ref), s_tea, LAYERS)
    for k, v in teacher.named_parameters():
        np.testing.assert_allclose(v.detach().numpy(), ref_sd[k].numpy(), atol=1e-7, rtol=1e-6,
                                   err_msg=k)
    for k, v in teacher.named_buffers():
        assert torch.equal(v, buffers_before[k]), k


# ---------------------------------------------------------------------------
# CrDoMix
# ---------------------------------------------------------------------------

def test_presence_and_pixel_mask_match_jax():
    labels = _labels((3, 12, 20), seed=4)
    sel = jax_mixing.sample_half_classes(jnp.asarray(labels), jax.random.PRNGKey(3), K)
    lt = torch.from_numpy(labels)
    np.testing.assert_array_equal(mixing.class_presence(lt, K).numpy(),
                                  np.asarray(jax_mixing.class_presence(jnp.asarray(labels), K)))
    np.testing.assert_array_equal(
        mixing.selection_to_pixel_mask(lt, torch.from_numpy(np.asarray(sel)), K).numpy(),
        np.asarray(jax_mixing.selection_to_pixel_mask(jnp.asarray(labels), sel, K)))


def test_sample_half_classes_selects_half_the_present_classes():
    labels = torch.from_numpy(_labels((4, 12, 20), seed=5))
    gen = torch.Generator().manual_seed(0)
    sel = mixing.sample_half_classes(labels, gen, K)
    present = mixing.class_presence(labels, K)
    assert torch.all(sel[:, K] == 1)
    assert torch.all(sel[:, :K] <= present[:, :K])
    n_present = present.sum(-1)
    # floor(n/2) draws among the present classes, the ignore slot included,
    # plus the forced ignore slot when the draw missed it
    n_sel = sel.sum(-1)
    assert torch.all((n_sel == torch.floor(n_present / 2)) | (n_sel == torch.floor(n_present / 2) + 1))
    again = mixing.sample_half_classes(labels, torch.Generator().manual_seed(0), K)
    assert torch.equal(sel, again)


def test_crdomix_with_injected_selection_is_exact():
    rng = np.random.default_rng(6)
    translated = rng.normal(size=(2, 12, 20, 3)).astype(np.float32)
    source_aug = rng.normal(size=(2, 12, 20, 3)).astype(np.float32)
    labels = _labels((2, 12, 20), seed=7)
    key = jax.random.PRNGKey(11)
    sel = np.asarray(jax_mixing.sample_half_classes(jnp.asarray(labels), key, K))
    ref = jax_mixing.crdomix(jnp.asarray(translated), jnp.asarray(source_aug),
                             jnp.asarray(labels), key, K)
    ours = mixing.crdomix(torch.from_numpy(translated), torch.from_numpy(source_aug),
                          torch.from_numpy(labels), torch.from_numpy(sel), K)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# photometric
# ---------------------------------------------------------------------------

def _jax_draws(rng, b, p_jitter=0.5):
    """The draws of diga_tpu.ops.photometric.photometric_chain, same keys."""
    keys = jax.random.split(rng, 10)
    u = lambda k, lo=0.0, hi=1.0: np.asarray(
        jax.random.uniform(k, (b, 1, 1, 1), minval=lo, maxval=hi)).reshape(b)
    return {
        "jitter": torch.from_numpy(u(keys[0]) < p_jitter),
        "brightness": torch.from_numpy(u(keys[1], 0.6, 1.4)),
        "contrast": torch.from_numpy(u(keys[2], 0.6, 1.4)),
        "saturation": torch.from_numpy(u(keys[3], 0.8, 1.2)),
        "hue": torch.from_numpy(u(keys[4], -0.1, 0.1)),
        "gray": torch.from_numpy(u(keys[5]) < 0.3),
        "blur": torch.from_numpy(u(keys[6]) < 0.8),
        "sharp": torch.from_numpy(u(keys[7]) < 0.3),
        "sharp_factor": torch.from_numpy(u(keys[8], 0.0, 0.5)),
    }


def _images(b, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1.0, 1.0, size=(b, 10, 14, 3)) * 0.8).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_sharpness", [True, False])
def test_diga_photometric_with_jax_draws(seed, with_sharpness):
    b = 6
    x = _images(b, seed)
    key = jax.random.PRNGKey(seed)
    draws = _jax_draws(key, b)
    ours = P.diga_photometric(torch.from_numpy(x), draws, 0.4, with_sharpness=with_sharpness)
    ref = jax_photo.diga_photometric(jnp.asarray(x), key, 0.4, "diga",
                                     with_sharpness=with_sharpness)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_photometric_chain_every_gate_on():
    """Every branch applied to every image (the port's draws; JAX has no
    way to force its gates), against the JAX ops composed by hand."""
    b = 3
    unit = np.clip(np.asarray(jax_photo.to_unit(jnp.asarray(_images(b, 4)))), 0, 1)
    draws = P.draw(torch.Generator().manual_seed(1), b)
    for k in ("jitter", "gray", "blur", "sharp"):
        draws[k] = torch.ones(b, dtype=torch.bool)
    ours = P.photometric_chain(torch.from_numpy(unit), draws).numpy()

    f = {k: jnp.asarray(v.numpy().reshape(b, 1, 1, 1)) for k, v in draws.items()}
    w = jax_photo._GRAY_W_BGR
    x = jnp.asarray(unit)
    xj = jnp.clip(x * f["brightness"], 0, 1)
    mg = jnp.mean(jnp.sum(xj * w, -1, keepdims=True), axis=(1, 2), keepdims=True)
    xj = jnp.clip((xj - mg) * f["contrast"] + mg, 0, 1)
    g = jnp.sum(xj * w, -1, keepdims=True)
    xj = jnp.clip(g + (xj - g) * f["saturation"], 0, 1)
    hsv = jax_photo._rgb_to_hsv(xj[..., ::-1])
    hsv = hsv.at[..., 0].set((hsv[..., 0] + f["hue"][..., 0]) % 1.0)
    x = jax_photo._hsv_to_rgb(hsv)[..., ::-1]
    x = jnp.sum(x * w, -1, keepdims=True) * jnp.ones_like(x)
    x = jax_photo.gaussian_blur(x, 3, 2.0)
    smooth = jnp.clip(jax_photo.gaussian_blur(x, 3, 1.0), 0, 1)
    ref = x + (smooth - x) * f["sharp_factor"]
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_draws_come_from_the_generator():
    a = P.draw(torch.Generator().manual_seed(5), 4)
    b = P.draw(torch.Generator().manual_seed(5), 4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["jitter"].dtype == torch.bool and a["brightness"].shape == (4,)
    assert bool((a["brightness"] >= 0.6).all() and (a["brightness"] <= 1.4).all())


def test_beta_zero_is_identity():
    x = torch.from_numpy(_images(2, 3))
    draws = P.draw(torch.Generator().manual_seed(0), 2)
    assert torch.equal(P.diga_photometric(x, draws, 0.0), x)


@pytest.mark.parametrize("sigma", [2.0, 1.0])
def test_gaussian_blur_matches_jax(sigma):
    x = np.random.default_rng(8).uniform(size=(2, 9, 13, 3)).astype(np.float32)
    ours = P.gaussian_blur(torch.from_numpy(x), 3, sigma).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax_photo.gaussian_blur(jnp.asarray(x), 3, sigma)),
                               atol=1e-6, rtol=1e-6)


def test_hsv_round_trip_matches_jax():
    rgb = np.random.default_rng(9).uniform(0.0, 1.0, size=(2, 8, 8, 3)).astype(np.float32)
    hsv = P.rgb_to_hsv(torch.from_numpy(rgb))
    np.testing.assert_allclose(hsv.numpy(), np.asarray(jax_photo._rgb_to_hsv(jnp.asarray(rgb))),
                               atol=1e-6)
    np.testing.assert_allclose(P.hsv_to_rgb(hsv).numpy(), rgb, atol=1e-5)


# ---------------------------------------------------------------------------
# schedules and the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["poly", "warmup"])
def test_schedules_match_jax(kind):
    if kind == "poly":
        ours, ref = schedules.poly_schedule(2.5e-4, 1000), jax_sched.poly_schedule(2.5e-4, 1000)
    else:
        ours = schedules.poly_warmup_schedule(2.5e-4, 1000, warmup=100)
        ref = jax_sched.poly_warmup_schedule(2.5e-4, 1000, warmup=100)
    for step in (0, 1, 50, 100, 101, 500, 999, 1000, 1200):
        assert ours(step) == pytest.approx(float(ref(jnp.asarray(step))), rel=1e-6, abs=1e-12)


def test_grouped_sgd_matches_jax_over_five_updates():
    _, params, stats = jax_tiny_deeplab(seed=3)
    model = _port_model(params, stats)
    sched = schedules.poly_schedule(2.5e-4, 20)
    opt = optim.sgd_grouped(model, 2.5e-4, momentum=0.9, weight_decay=5e-4, head_mult=10.0)
    jopt = jax_optim.sgd_grouped(jax_sched.poly_schedule(2.5e-4, 20), head_param_mask(params),
                                 momentum=0.9, weight_decay=5e-4, head_mult=10.0)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    rng = np.random.default_rng(12)
    named = dict(model.named_parameters())
    for step in range(5):
        grads = jax.tree_util.tree_map(
            lambda a: (rng.normal(size=a.shape) * 0.1).astype(np.float32), params)
        g_sd = state_dict_from_jax(grads, stats, LAYERS)
        for k, p in named.items():
            p.grad = g_sd[k].clone() if p.requires_grad else None
        optim.set_lr(opt, sched(step))
        opt.step()
        updates, jstate = jopt.update(grads, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams), stats, LAYERS)
    mu = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate["mu"]), stats, LAYERS)
    moved = 0
    for k, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[k].numpy(), atol=1e-7, rtol=1e-6,
                                   err_msg=k)
        if p.requires_grad:
            buf = opt.state[p]["momentum_buffer"]
            np.testing.assert_allclose(buf.numpy(), mu[k].numpy(), atol=1e-6, rtol=1e-5,
                                       err_msg=k)
            moved += 1
        else:  # BN affine: out of the optimizer, never moves
            assert ".bn" in k or "downsample.1" in k or k.startswith("layer0.1"), k
    assert moved > 0
