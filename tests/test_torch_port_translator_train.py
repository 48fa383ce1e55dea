"""The port's translator stage (diga_tpu_torch) against the JAX package's.

Tiny modules (encoder width 8, decoder 32, one residual block,
discriminator width 8 with 2 layers and 3 scales), crop 32x64, f32, inputs
made from seeded numpy arrays; JAX parameters cross over through
``translator_state_dict_from_jax`` and load with ``strict=True``.

* ``nearest_up2_conv5x5`` against its plain form and both JAX forms at 1e-5
  in f32, in bf16 (0.05 of the output's largest magnitude, the JAX tests'
  bound for bf16 reassociation), and on the tiny-input fallback (equal);
  the subpixel decoder loads the plain decoder's state_dict strictly and
  gives its output at 1e-5 of the largest magnitude;
* the Discriminator (3 scales) and its empty-output error, each loss and
  the VGG19 taps and perceptual loss against JAX;
* the translator step, fused and unfused, against the jitted JAX step over
  5 steps: the first step's per-module gradients at 1e-4 of the module's
  largest gradient; every step's losses at rel 1e-4; after every step the
  six modules' parameters as below; the port's fused step against its
  unfused one the same way;
* the exported ``.pth`` files read by JAX's converters with equal outputs;
* the translator CLI on GTA5 and SYNTHIA fixtures, feeding the warm-up.

The parameter check.  Adam moves a weight by lr·m̂/√v̂, so a gradient that
is only rounding noise moves its weight by about lr whatever its size.  The
conv biases right before an InstanceNorm have a gradient of exactly zero in
exact arithmetic; the rule ``NOISE`` (a JAX gradient at most 1e-4 of its
module's largest at every step) picks exactly those, which a test holds by
name (on these inputs they sit at <= 1.6e-6, every other parameter at
>= 1.1e-2).  Their sign differs between two runs, and so does their update,
by up to 2·lr_t·C_t at step t, where C_t = max |m̂/√v̂| = sqrt(Σ_k w_k²/u_k)
by Cauchy-Schwarz over the first-moment weights w_k = (1−β1)β1^(t−k)/(1−β1^t)
and the second-moment weights u_k = (1−β2)β2^(t−k)/(1−β2^t).  These alone
are held to Σ_{t≤n} 2·lr_t·C_t after n steps (1.13e-3 at lr 1e-4 after 5).

Every other parameter carries a real gradient and is held per module to
‖Δp_port − Δp_jax‖ / ‖Δp_jax‖ <= ``TOL`` = 1e-3 with Δp = p_t − p_0
(measured: at most 1.1e-4).  A schedule shifted by one step misses it by
9x at step 1 (Δp off by 0.9 %) and by 40-84x after; β1 = 0.9, which step 1
cannot show (its update is lr·sign(g) whatever β1), by 130-330x from step
2; a test holds both.  JAX's fused and unfused steps compute one function,
yet its own two runs drift apart by up to 1.3e-3 per module over these 5
steps (from step 3, while their losses agree to 6e-7), and the port's
unfused run follows its fused one.  So the unfused comparison is held to
``TOL`` plus the reference's own fused-to-unfused gap at that step and
module (triangle inequality through the fused reference), and that gap
is itself held under 5·``TOL``.
"""

import copy
import dataclasses
import math
import os
import re
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from diga_tpu.models.convert_translator import (decoder_from_torch, discriminator_from_torch,
                                                encoder_from_torch)
from diga_tpu.models.translator import Discriminator as JaxDis
from diga_tpu.models.translator import ImgDecoder as JaxDec
from diga_tpu.models.translator import ImgEncoder as JaxEnc
from diga_tpu.models.vgg import VGG19Features as JaxVGG
from diga_tpu.models.vgg import vgg19_from_torch
from diga_tpu.models.vgg import vgg_perceptual_loss as jax_perceptual
from diga_tpu.ops import losses as JL
from diga_tpu.ops.subpixel import nearest_up2_conv5x5 as jax_subpixel
from diga_tpu.ops.subpixel import nearest_up2_conv5x5_reference as jax_subpixel_ref
from diga_tpu.train.schedules import poly_schedule as jax_poly
from diga_tpu.train.steps_translator import TranslatorConfig as JaxConfig
from diga_tpu.train.steps_translator import build_translator_step as jax_build_step
from diga_tpu.train.steps_translator import create_translator_state as jax_create_state
import diga_tpu_torch.cli.train_domain_translator as cli
import diga_tpu_torch.cli.train_warm_up as warm_up
from diga_tpu_torch.configs import presets
from diga_tpu_torch.data import synthetic
from diga_tpu_torch.models.convert import translator_state_dict_from_jax
from diga_tpu_torch.models.translator import (Conv2dBlock, Discriminator, ImgDecoder, ImgEncoder,
                                              SubpixelUpBlock)
from diga_tpu_torch.models.vgg import VGG19Features, vgg_perceptual_loss
from diga_tpu_torch.ops import losses as L
from diga_tpu_torch.ops.subpixel import nearest_up2_conv5x5, nearest_up2_conv5x5_reference
from diga_tpu_torch.train.schedules import poly_schedule
from diga_tpu_torch.train.steps_translator import (ROLES, TranslatorConfig, build_translator_step,
                                                   create_translator_state)
from diga_tpu_torch.utils.checkpoint import load_role_keyed

CROP = (32, 64)
B = 2
LR = 1e-4
MAX_ITER = 100
N_STEPS = 5
BETAS = (0.5, 0.999)
ENC = dict(dim=8, n_downsample=2, n_res=1)
DEC = dict(dim=32, n_upsample=2, n_res=1)
DIS = dict(dim=8, n_layer=2, num_scales=3)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the test run has several workers on one host,
    and more threads per worker only contend."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed after the test: the checkpoints these
    tests write at the reference translator widths take hundreds of MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close_to_max(ours: np.ndarray, ref: np.ndarray, rel: float) -> None:
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * np.abs(ref).max())


# ---------------------------------------------------------------- subpixel

@pytest.mark.parametrize("h,w", [(8, 12), (5, 7), (3, 3), (16, 9)])
def test_subpixel_matches_the_plain_form_and_both_jax_forms_f32(h, w):
    rng = np.random.default_rng(h * 100 + w)
    x = rng.normal(size=(2, h, w, 6)).astype(np.float32)
    w5 = (rng.normal(size=(5, 5, 6, 4)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(4,)).astype(np.float32)
    args = (_nchw(x), torch.from_numpy(w5).permute(3, 2, 0, 1), torch.from_numpy(bias))
    ours, plain = _nhwc(nearest_up2_conv5x5(*args)), _nhwc(nearest_up2_conv5x5_reference(*args))
    assert ours.shape == (2, 2 * h, 2 * w, 4)
    jargs = (jnp.asarray(x), jnp.asarray(w5), jnp.asarray(bias))
    for ref in (plain, np.asarray(jax_subpixel(*jargs)), np.asarray(jax_subpixel_ref(*jargs))):
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_subpixel_bf16():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 10, 14, 8)).astype(np.float32)
    w5 = (rng.normal(size=(5, 5, 8, 4)) * 0.2).astype(np.float32)
    xt = _nchw(x).to(torch.bfloat16)
    wt = torch.from_numpy(w5).permute(3, 2, 0, 1).to(torch.bfloat16)
    ours = _nhwc(nearest_up2_conv5x5(xt, wt).float())
    plain = _nhwc(nearest_up2_conv5x5_reference(xt, wt).float())
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w5, jnp.bfloat16)
    for ref in (plain, np.asarray(jax_subpixel(jx, jw).astype(jnp.float32)),
                np.asarray(jax_subpixel_ref(jx, jw).astype(jnp.float32))):
        _close_to_max(ours, ref, 0.05)


def test_subpixel_tiny_input_falls_back_to_the_plain_form():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 2, 2, 3)).astype(np.float32)
    w5 = rng.normal(size=(5, 5, 3, 2)).astype(np.float32)
    xt, wt = _nchw(x), torch.from_numpy(w5).permute(3, 2, 0, 1)
    ours = nearest_up2_conv5x5(xt, wt)
    assert torch.equal(ours, nearest_up2_conv5x5_reference(xt, wt))
    np.testing.assert_allclose(_nhwc(ours), np.asarray(jax_subpixel(jnp.asarray(x),
                                                                    jnp.asarray(w5))),
                               rtol=1e-5, atol=1e-5)


def test_subpixel_decoder_loads_the_plain_state_dict_and_matches_jax():
    plain = ImgDecoder(**DEC)
    sub = ImgDecoder(**DEC, subpixel_up=True)
    assert sub.state_dict().keys() == plain.state_dict().keys()
    assert {"model.2.conv.weight", "model.4.conv.bias", "model.5.conv.weight"} <= set(
        sub.state_dict())
    sub.load_state_dict(plain.state_dict(), strict=True)
    z = np.random.default_rng(2).normal(size=(2, 8, 16, 32)).astype(np.float32)
    with torch.no_grad():
        ours, ref = _nhwc(sub(_nchw(z))), _nhwc(plain(_nchw(z)))
    _close_to_max(ours, ref, 1e-5)
    params = decoder_from_torch({k: v.numpy() for k, v in plain.state_dict().items()},
                                n_upsample=2, n_res=1)
    jax_out = jax.jit(JaxDec(**DEC, subpixel_up=True).apply)({"params": params}, jnp.asarray(z))
    _close_to_max(ours, np.asarray(jax_out), 1e-5)


# ------------------------------------------------- discriminator and losses

@pytest.fixture(scope="module")
def jax_dis():
    dis = JaxDis(**DIS)
    x = jnp.zeros((1, *CROP, 3), jnp.float32)
    return dis, _np(jax.jit(dis.init)(jax.random.PRNGKey(4), x)["params"])


def test_discriminator_matches_jax(jax_dis):
    dis, params = jax_dis
    ours_mod = Discriminator(**DIS)
    ours_mod.load_state_dict(translator_state_dict_from_jax({"dis_s2t": params})["dis_s2t"],
                             strict=True)
    x = np.random.default_rng(5).normal(size=(2, *CROP, 3)).astype(np.float32)
    refs = jax.jit(dis.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        ours = ours_mod(_nchw(x))
    assert [tuple(o.shape) for o in ours] == [(2, 1, 8, 16), (2, 1, 4, 8), (2, 1, 2, 4)]
    for o, r in zip(ours, refs):
        _close_to_max(_nhwc(o), np.asarray(r), 1e-5)


def test_discriminator_refuses_an_empty_scale():
    with pytest.raises(ValueError, match="scale 2 output is empty"):
        Discriminator(dim=8, n_layer=4, num_scales=3)(torch.zeros(1, 3, 32, 64))


def _images(seed, n=2):
    rng = np.random.default_rng(seed)
    return [np.tanh(rng.normal(size=(B, *CROP, 3))).astype(np.float32) for _ in range(n)]


def _labels(seed):
    rng = np.random.default_rng(seed)
    lbl = rng.choice(rng.choice(19, size=5, replace=False), size=(B, *CROP)).astype(np.int32)
    lbl[:, :3] = 255
    return lbl


@pytest.mark.parametrize("name", ["l1_loss", "lsgan_d_loss", "lsgan_g_loss", "laplacian2d",
                                  "seg_edge_loss"])
def test_loss_matches_jax(name):
    a, b = _images(6)
    lbl = _labels(7)
    scores = [np.random.default_rng(8 + i).normal(size=(B, 8 >> i, 16 >> i, 1)).astype(np.float32)
              for i in range(3)]
    if name == "l1_loss":
        ours, ref = L.l1_loss(_nchw(a), _nchw(b)), JL.l1_loss(jnp.asarray(a), jnp.asarray(b))
    elif name == "lsgan_d_loss":
        ours = L.lsgan_d_loss([_nchw(s) for s in scores], [_nchw(s * 0.5) for s in scores])
        ref = JL.lsgan_d_loss([jnp.asarray(s) for s in scores],
                              [jnp.asarray(s * 0.5) for s in scores])
    elif name == "lsgan_g_loss":
        ours = L.lsgan_g_loss([_nchw(s) for s in scores])
        ref = JL.lsgan_g_loss([jnp.asarray(s) for s in scores])
    elif name == "laplacian2d":
        ours = _nhwc(L.laplacian2d(_nchw(a)))
        ref = np.asarray(JL.laplacian2d(jnp.asarray(a)))
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
        return
    else:
        ours = L.seg_edge_loss(_nchw(a), _nchw(b), torch.from_numpy(lbl))
        ref = JL.seg_edge_loss(jnp.asarray(a), jnp.asarray(b), jnp.asarray(lbl))
    assert ours.dtype == torch.float32
    assert float(ours) == pytest.approx(float(ref), rel=1e-6)


# ---------------------------------------------------------------- VGG19

def _vgg_state_dict(seed):
    """A torchvision-layout VGG19 state_dict (``features.N.*`` and a
    classifier entry the loader drops) from seeded normals."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in VGG19Features().state_dict().items():
        fan_in = int(np.prod(v.shape[1:])) if v.ndim == 4 else 1
        sd[k] = torch.from_numpy((rng.normal(size=v.shape) / math.sqrt(fan_in)
                                  * (1.0 if v.ndim == 4 else 0.01)).astype(np.float32))
    sd["classifier.0.weight"] = torch.zeros(4, 4)
    return sd


def test_vgg_taps_and_perceptual_loss_match_jax():
    sd = _vgg_state_dict(9)
    vgg = VGG19Features().load_torchvision(sd)
    params = vgg19_from_torch({k: v.numpy() for k, v in sd.items()})
    japply = jax.jit(lambda x: JaxVGG().apply({"params": params}, x))
    x, y = _images(10)
    with torch.no_grad():
        taps = vgg(_nchw(x))
    refs = japply(jnp.asarray(x))
    assert len(taps) == len(refs) == 5
    for t, r in zip(taps, refs):
        _close_to_max(_nhwc(t), np.asarray(r), 1e-5)
    for max_w in (1024, 32):  # 32: both images halved once, as the reference does past 1024
        ours = vgg_perceptual_loss(vgg, _nchw(x), _nchw(y), max_w=max_w)
        ref = jax_perceptual(japply, jnp.asarray(x), jnp.asarray(y), max_w=max_w)
        assert float(ours) == pytest.approx(float(ref), rel=1e-5)


# ------------------------------------------------------ the translator step

def _jax_modules():
    return {"enc_s": JaxEnc(**ENC), "enc_t": JaxEnc(**ENC),
            "dec_s2t": JaxDec(**DEC, subpixel_up=True), "dec_t2s": JaxDec(**DEC, subpixel_up=True),
            "dis_s2t": JaxDis(**DIS), "dis_t2s": JaxDis(**DIS)}


def _record_gradients():
    """An optax stage that keeps the gradient it is given in its state."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)},
        lambda u, s, p=None: (u, {"g": u}))


def _port_modules(sds: dict) -> torch.nn.ModuleDict:
    """The six port modules loaded strictly from role-keyed state dicts."""
    mods = torch.nn.ModuleDict({
        "enc_s": ImgEncoder(**ENC), "enc_t": ImgEncoder(**ENC),
        "dec_s2t": ImgDecoder(**DEC, subpixel_up=True),
        "dec_t2s": ImgDecoder(**DEC, subpixel_up=True),
        "dis_s2t": Discriminator(**DIS), "dis_t2s": Discriminator(**DIS)})
    for r in ROLES:
        mods[r].load_state_dict(sds[r], strict=True)
    return mods


def _batch(i):
    rr = np.random.default_rng(100 + i)
    return {"s_img": (rr.normal(size=(B, *CROP, 3)) * 0.5).astype(np.float32),
            "s_lbl": _labels(200 + i),
            "t_img": (rr.normal(size=(B, *CROP, 3)) * 0.5).astype(np.float32)}


def _port_run(init, fuse, schedule=poly_schedule(LR, MAX_ITER), beta1=BETAS[0]):
    state = create_translator_state(_port_modules(init), LR)
    for opt in state.optimizers.values():  # beta1: a fault for the check's own test
        for g in opt.param_groups:
            g["betas"] = (beta1, g["betas"][1])
    step = build_translator_step(TranslatorConfig(fuse=fuse, compute_dtype=torch.float32),
                                 schedule)
    out = []
    for i in range(N_STEPS):
        metrics = step(state, {k: torch.from_numpy(v) for k, v in _batch(i).items()})
        out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                    "params": {r: {k: v.clone() for k, v in state.modules[r].state_dict().items()}
                               for r in ROLES},
                    "grads": {r: {k: p.grad.clone() for k, p in state.modules[r].named_parameters()}
                              for r in ROLES}})
    assert state.step == N_STEPS
    return out


@pytest.fixture(scope="module")
def runs():
    """5 steps fused and unfused on both sides from one JAX init."""
    opt = optax.chain(_record_gradients(),
                      optax.adam(jax_poly(LR, MAX_ITER), b1=BETAS[0], b2=BETAS[1]))
    mods = _jax_modules()
    # jitted at XLA's lowest optimisation level: the eager flax inits take
    # about 20 s on a CPU; both sides start from these parameters
    jstate0 = jax.jit(lambda key: jax_create_state(mods, opt, key, CROP),
                      compiler_options={"xla_backend_optimization_level": 0})(
        jax.random.PRNGKey(0))
    out = {"init": translator_state_dict_from_jax(_np(jstate0.params))}
    for fuse in (True, False):
        jstep = jax.jit(jax_build_step(mods, opt, JaxConfig(fuse=fuse)))
        jstate, traj = jstate0, []
        for i in range(N_STEPS):
            jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in _batch(i).items()})
            traj.append({"metrics": {k: float(v) for k, v in m.items()},
                         "params": translator_state_dict_from_jax(_np(jstate.params)),
                         "grads": translator_state_dict_from_jax(
                             {r: _np(jstate.opt_state[r][0]["g"]) for r in ROLES})})
        name = "fused" if fuse else "unfused"
        out[name] = {"jax": traj, "port": _port_run(out["init"], fuse)}
    out["noise"] = _noise(out["fused"]["jax"])
    return out


def adam_bound(n_steps: int) -> float:
    """Σ_{t≤n} 2·lr_t·C_t (the module docstring)."""
    b1, b2 = BETAS
    total = 0.0
    for t in range(1, n_steps + 1):
        w = [(1 - b1) * b1 ** (t - k) / (1 - b1 ** t) for k in range(1, t + 1)]
        u = [(1 - b2) * b2 ** (t - k) / (1 - b2 ** t) for k in range(1, t + 1)]
        total += 2 * poly_schedule(LR, MAX_ITER)(t - 1) * math.sqrt(
            sum(a * a / c for a, c in zip(w, u)))
    return total


NOISE = 1e-4
TOL = 1e-3
METRICS = {"loss_g", "loss_d_s2t", "loss_d_t2s", "loss_adv", "loss_cyc", "loss_edge", "loss_self"}


def _noise(traj) -> set[tuple[str, str]]:
    """(role, name) of each parameter whose gradient stays at most ``NOISE``
    of its module's largest at every step of ``traj``."""
    out = set()
    for r in ROLES:
        for k in traj[0]["grads"][r]:
            if all(float(t["grads"][r][k].abs().max())
                   <= NOISE * max(float(v.abs().max()) for v in t["grads"][r].values())
                   for t in traj):
                out.add((r, k))
    return out


def _param_gaps(a_traj, b_traj, init, noise) -> list[dict[str, float]]:
    """Per step: for each module, ‖Δp_a − Δp_b‖ / ‖Δp_b‖ over its parameters
    not in ``noise`` (Δp = p_t − p_0); under "adam", the largest gap of a
    noise parameter over the Adam bound."""
    gaps = []
    for i, (a, b) in enumerate(zip(a_traj, b_traj)):
        row = {"adam": 0.0}
        for r in ROLES:
            assert a["params"][r].keys() == b["params"][r].keys()
            num = den = 0.0
            for k, v in b["params"][r].items():
                diff = (a["params"][r][k] - v).double()
                if (r, k) in noise:
                    row["adam"] = max(row["adam"], float(diff.abs().max()) / adam_bound(i + 1))
                else:
                    num += float(diff.square().sum())
                    den += float((v - init[r][k]).double().square().sum())
            row[r] = math.sqrt(num / den)
        gaps.append(row)
    return gaps


@pytest.mark.parametrize("form", ["fused", "unfused"])
def test_first_step_gradients_match_jax(runs, form):
    ours, ref = runs[form]["port"][0]["grads"], runs[form]["jax"][0]["grads"]
    for r in ROLES:
        assert ours[r].keys() == ref[r].keys()
        scale = max(float(v.abs().max()) for v in ref[r].values())
        for k, v in ref[r].items():
            err = float((ours[r][k] - v).abs().max())
            assert err <= 1e-4 * scale, (r, k, err, scale)


@pytest.mark.parametrize("form", ["fused", "unfused"])
def test_five_steps_losses_match_jax(runs, form):
    for i, (ours, ref) in enumerate(zip(runs[form]["port"], runs[form]["jax"])):
        assert set(ours["metrics"]) == set(ref["metrics"]) == METRICS
        for k, v in ref["metrics"].items():
            assert ours["metrics"][k] == pytest.approx(v, rel=1e-4), (i, k)


@pytest.mark.parametrize("form", ["fused", "unfused"])
def test_noise_gradients_are_the_biases_before_an_instance_norm(runs, form):
    mods = _port_modules(runs["init"])
    in_biases = {(r, f"{n}.conv.bias") for r in ROLES for n, m in mods[r].named_modules()
                 if isinstance(m, SubpixelUpBlock)
                 or (isinstance(m, Conv2dBlock) and m.norm == "in")}
    assert len(in_biases) == 18
    assert _noise(runs[form]["jax"]) == in_biases == runs["noise"]


def _tolerances(runs, form) -> list[dict[str, float]]:
    """``TOL``; for the unfused form plus the reference's own gap between
    its fused and unfused runs (the module docstring)."""
    if form == "fused":
        return [dict.fromkeys(ROLES, TOL)] * N_STEPS
    spread = _param_gaps(runs["unfused"]["jax"], runs["fused"]["jax"], runs["init"],
                         runs["noise"])
    assert max(g[r] for g in spread for r in ROLES) <= 5 * TOL, spread
    return [{r: TOL + g[r] for r in ROLES} for g in spread]


@pytest.mark.parametrize("form", ["fused", "unfused"])
def test_five_steps_parameters_match_jax(runs, form):
    gaps = _param_gaps(runs[form]["port"], runs[form]["jax"], runs["init"], runs["noise"])
    for i, (gap, tol) in enumerate(zip(gaps, _tolerances(runs, form))):
        assert gap["adam"] <= 1.0, (i, gap)
        for r in ROLES:
            assert gap[r] <= tol[r], (i, r, gap[r], tol[r])
    first, last = (t["params"]["dec_s2t"]["model.5.conv.weight"]
                   for t in (runs[form]["port"][0], runs[form]["port"][-1]))
    assert not torch.equal(first, last), "the decoder never moved"


@pytest.mark.parametrize("fault", ["beta1_0.9", "schedule_one_step_late"])
def test_the_parameter_check_catches_an_optimizer_fault(runs, fault):
    """A port run with β1 = 0.9, or with lr_t taken at step t + 1, fails the
    parameter check against both JAX forms, though its first step moves
    every weight by the same lr·sign(g) (β1) or by 0.9 % less (schedule)."""
    kw = ({"beta1": 0.9} if fault == "beta1_0.9" else
          {"schedule": lambda i: poly_schedule(LR, MAX_ITER)(i + 1)})
    faulty = _port_run(runs["init"], True, **kw)
    for form in ("fused", "unfused"):
        gaps = _param_gaps(faulty, runs[form]["jax"], runs["init"], runs["noise"])
        tols = _tolerances(runs, form)
        assert any(g[r] > t[r] for g, t in zip(gaps, tols) for r in ROLES), (form, gaps)


def test_fused_step_matches_the_unfused_in_the_port(runs):
    fused, unfused = runs["fused"]["port"], runs["unfused"]["port"]
    for a, b in zip(fused, unfused):
        for k, v in b["metrics"].items():
            assert a["metrics"][k] == pytest.approx(v, rel=1e-4), k
    for i, gap in enumerate(_param_gaps(fused, unfused, runs["init"], runs["noise"])):
        assert gap["adam"] <= 1.0, (i, gap)
        for r in ROLES:
            assert gap[r] <= TOL, (i, r, gap[r])


def test_remat_changes_nothing():
    """The step with every module call under ``torch.utils.checkpoint`` and
    the perceptual term (remat's default) equals the step without remat."""
    torch.manual_seed(0)
    mods = torch.nn.ModuleDict({
        "enc_s": ImgEncoder(**ENC), "enc_t": ImgEncoder(**ENC),
        "dec_s2t": ImgDecoder(**DEC, subpixel_up=True),
        "dec_t2s": ImgDecoder(**DEC, subpixel_up=True),
        "dis_s2t": Discriminator(**DIS), "dis_t2s": Discriminator(**DIS)})
    vgg_sd = _vgg_state_dict(11)
    results = []
    for remat in (None, False):
        state = create_translator_state(copy.deepcopy(mods), LR,
                                        VGG19Features().load_torchvision(vgg_sd))
        step = build_translator_step(TranslatorConfig(remat=remat, compute_dtype=torch.float32),
                                     poly_schedule(LR, MAX_ITER), with_vgg=True)
        metrics = [step(state, {k: torch.from_numpy(v) for k, v in _batch(i).items()})
                   for i in range(2)]
        results.append((metrics, {r: state.modules[r].state_dict() for r in ROLES}))
    (m_remat, p_remat), (m_plain, p_plain) = results
    for a, b in zip(m_remat, m_plain):
        for k in b:
            assert float(a[k]) == pytest.approx(float(b[k]), rel=1e-6), k
    for r in ROLES:
        for k, v in p_plain[r].items():
            assert float((p_remat[r][k] - v).abs().max()) <= 1e-6, (r, k)


# ------------------------------------------------------------ export and CLI

def test_exported_pth_read_by_the_jax_converters(tmp_path):
    cfg = dataclasses.replace(presets.get_preset("gta2city_translator"),
                              extra={"enc_dim": 8, "dec_dim": 32, "n_res": 1, "dis_dim": 8,
                                     "dis_layers": 2, "dis_scales": 3})
    state = create_translator_state(cli.make_translator(cfg), LR)
    cli.export_translator(state, str(tmp_path))
    sds = {r: {k: v.numpy() for k, v in sd.items()}
           for r, sd in load_role_keyed(str(tmp_path), list(ROLES)).items()}
    x = np.random.default_rng(12).normal(size=(2, *CROP, 3)).astype(np.float32)
    with torch.no_grad():
        z = state.modules["enc_t"](_nchw(x))
        img = state.modules["dec_t2s"](z)
        scores = state.modules["dis_t2s"](_nchw(x))
    jz = jax.jit(JaxEnc(**ENC).apply)({"params": encoder_from_torch(sds["enc_t"], 2, 1)},
                                      jnp.asarray(x))
    _close_to_max(_nhwc(z), np.asarray(jz), 1e-5)
    jimg = jax.jit(JaxDec(**DEC, subpixel_up=True).apply)(
        {"params": decoder_from_torch(sds["dec_t2s"], 2, 1)}, jnp.asarray(_nhwc(z)))
    _close_to_max(_nhwc(img), np.asarray(jimg), 1e-5)
    jscores = jax.jit(JaxDis(**DIS).apply)(
        {"params": discriminator_from_torch(sds["dis_t2s"], 3, 2)}, jnp.asarray(x))
    for o, r in zip(scores, jscores):
        _close_to_max(_nhwc(o), np.asarray(r), 1e-5)
    for a, b in (("enc_s", "enc_t"), ("dec_s2t", "dec_t2s"), ("dis_s2t", "dis_t2s")):
        assert all(np.array_equal(sds[a][k], sds[b][k]) for k in sds[a])  # pairs start equal


HW = (40, 72)


def _tiny(name, num_steps=2):
    """The preset at crop 32x64 with small streams, f32, the reference
    encoder and decoder (the warm-up's frozen translator has their widths)
    and a small discriminator."""
    base = presets.get_preset(name)
    kind = base.data.source_streams[0].kind
    return dataclasses.replace(
        base,
        data=dataclasses.replace(
            base.data, num_workers=1,
            source_streams=(presets.LoaderSpec(kind, HW, 1), presets.LoaderSpec(kind, (48, 80), 1)),
            target_streams=(presets.LoaderSpec("cityscapes", HW, 1),
                            presets.LoaderSpec("cityscapes", (48, 80), 1))),
        train=dataclasses.replace(base.train, crop_hw=CROP, compute_dtype="float32",
                                  num_steps=num_steps),
        extra={**base.extra, "dis_dim": 8, "dis_layers": 2})


def _logged(out: str) -> list[dict]:
    return [dict((k, float(v)) for k, v in re.findall(r"(\w+)=([-\d.eE+naif]+)", line))
            for line in out.splitlines() if line.startswith("step ") and "loss_g=" in line]


@pytest.mark.parametrize("preset", ["gta2city_translator", "synthia2city_translator"])
def test_translator_cli_feeds_the_warm_up(preset, tmp_path, monkeypatch, capsys):
    source = "synthia" if preset.startswith("synthia") else "gta"
    make = synthetic.make_synthia_fixture if source == "synthia" else synthetic.make_gta5_fixture
    src_list = make(str(tmp_path / source), n=2, h=HW[0], w=HW[1])
    img, lbl = synthetic.make_cityscapes_fixture(str(tmp_path / "city"), n=2, h=HW[0], w=HW[1],
                                                 split="train")
    data = ["--source_root", str(tmp_path / source), "--source_list", src_list,
            "--target_root", str(tmp_path / "city"), "--target_img_list", img,
            "--target_lbl_list", lbl, "--device", "cpu"]
    monkeypatch.setitem(presets.PRESETS, "tiny_translator", _tiny(preset))
    wd = tmp_path / "translator"
    last = cli.main(["--preset", "tiny_translator", "--work_dir", str(wd), *data])
    logged = _logged(capsys.readouterr().out)
    assert len(logged) == 1 and set(logged[0]) == METRICS  # step 0 of every 50
    assert set(last) == METRICS and all(math.isfinite(v) for v in last.values())
    assert sorted(os.listdir(wd / "weights")) == sorted(f"{r}.pth" for r in ROLES)
    assert sorted(os.listdir(wd / "ckpt_final")) == sorted([f"{r}.pth" for r in ROLES]
                                                           + ["state.pth"])
    st = torch.load(wd / "ckpt_final" / "state.pth")
    assert st["step"] == 2 and set(st["optimizers"]) == set(ROLES)
    assert all(int(o["state"][0]["step"]) == 2 for o in st["optimizers"].values())
    sds = {r: {k: v.numpy() for k, v in sd.items()}
           for r, sd in load_role_keyed(str(wd / "weights"), list(ROLES)).items()}
    encoder_from_torch(sds["enc_s"]), decoder_from_torch(sds["dec_s2t"])  # the reference widths
    discriminator_from_torch(sds["dis_s2t"], num_scales=3, n_layer=2)
    # the warm-up of the same domain pair starts from these weights
    warm = "synthia2city_warmup" if source == "synthia" else "gta2city_warmup"
    base = presets.get_preset(warm)
    monkeypatch.setitem(presets.PRESETS, "tiny_warmup", dataclasses.replace(
        _tiny(warm, num_steps=1), train=dataclasses.replace(
            base.train, crop_hw=CROP, compute_dtype="float32", num_steps=1, eval_every=0),
        extra={"layers": (1, 1, 1, 1)}))
    result = warm_up.main(["--preset", "tiny_warmup", "--work_dir", str(tmp_path / "warmup"),
                           "--load_weight_dir", str(wd / "weights"), *data])
    assert all(math.isfinite(v) for v in result.last_metrics.values())
    enc = torch.load(tmp_path / "warmup" / "ckpt_final" / "enc_s.pth")
    assert all(torch.equal(v, torch.as_tensor(sds["enc_s"][k])) for k, v in enc.items())
