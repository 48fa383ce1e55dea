"""Shared 5-step warm-up and DG parity of tests/test_torch_port_train_step.py,
tests/test_torch_port_kornia.py and tests/test_torch_port_synthia.py, with
the step options those files hold: the class count, the segmentation loss
(OHEM), the LR warm-up, the photometric variant, its beta and ColorJitter p.

Both sides start from one JAX init (tiny depth, layers (1, 1, 1, 1), crop
32x64, f32, frozen BN biases at +4, perturbed BN statistics and teacher,
``droprate=0``, ``tgt_stats_forward=True``; the DG step without the
translator and RandomSharpness).  The CrDoMix selection and,
with beta > 0, the photometric draws are derived from the JAX step's own
key split (``steps.py:205``) the way the JAX functions split it, and
injected into the port.  Each step's losses agree at rel 1e-4; after each
step the student and teacher parameters, both models' BN running
statistics and the SGD momentum agree at atol 1e-5 / rtol 1e-4.

Also the JAX package's photometric draws from a key (``jax_diga_draws``,
``jax_kornia_draws``) and the per-step checks (``check``).
"""

import copy
import functools

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
from diga_tpu.train.schedules import poly_warmup_schedule as jax_poly_warmup
from diga_tpu.train.state import create_seg_state as jax_create_state
from diga_tpu.train.steps import StepConfig as JaxStepConfig
from diga_tpu.train.steps import build_dg_step as jax_build_dg_step
from diga_tpu.train.steps import build_warmup_step as jax_build_warmup_step
from diga_tpu_torch.models.convert import state_dict_from_jax, translator_state_dict_from_jax
from diga_tpu_torch.models.resnet_deeplab import DeepLabV2
from diga_tpu_torch.models.translator import ImgDecoder, ImgEncoder
from diga_tpu_torch.train.optim import sgd_grouped
from diga_tpu_torch.train.schedules import poly_schedule, poly_warmup_schedule
from diga_tpu_torch.train.state import create_seg_state
from diga_tpu_torch.train.steps import StepConfig, build_dg_step, build_warmup_step

LAYERS = (1, 1, 1, 1)
CROP = (32, 64)
B = 2
LR = 2.5e-4
MAX_ITER = 1000
N_STEPS = 5
ATOL, RTOL = 1e-5, 1e-4
WHAT = ["metrics", "student", "teacher", "running_stats", "momentum"]


def _uniform(key, b, lo=0.0, hi=1.0):
    return np.array(jax.random.uniform(key, (b, 1, 1, 1), minval=lo, maxval=hi)).reshape(b)


def jax_diga_draws(key, b, p_jitter=0.5) -> dict:
    """The draws of ``diga_tpu.ops.photometric.photometric_chain`` from ``key``."""
    keys = jax.random.split(key, 10)
    u = lambda i, lo=0.0, hi=1.0: torch.from_numpy(_uniform(keys[i], b, lo, hi))
    return {"jitter": u(0) < p_jitter, "brightness": u(1, 0.6, 1.4),
            "contrast": u(2, 0.6, 1.4), "saturation": u(3, 0.8, 1.2), "hue": u(4, -0.1, 0.1),
            "gray": u(5) < 0.3, "blur": u(6) < 0.8, "sharp": u(7) < 0.3,
            "sharp_factor": u(8, 0.0, 0.5)}


def jax_kornia_draws(key, b, p_jitter=0.5) -> dict:
    """The draws of ``diga_tpu.ops.photometric.kornia_photometric_chain`` from
    ``key``: ``keys = split(key, 12)``, the order from keys[0], the factors
    from keys[1:5], the gates from keys[5:9], the sharpness factor from
    keys[9] (``photometric.py:200-254``)."""
    keys = jax.random.split(key, 12)
    u = lambda i, lo=0.0, hi=1.0: torch.from_numpy(_uniform(keys[i], b, lo, hi))
    return {"order": torch.from_numpy(np.array(jax.random.permutation(keys[0], 4))),
            "brightness": u(1, -0.4, 0.4), "contrast": u(2, 0.6, 1.4),
            "saturation": u(3, 0.8, 1.2), "hue": u(4, -0.1, 0.1),
            "jitter": u(5) < p_jitter, "gray": u(6) < 0.3, "blur": u(7) < 0.8,
            "sharp": u(8) < 0.3, "sharp_factor": u(9, 0.0, 0.5)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class _JittedInit:
    """``model`` for ``create_seg_state``, whose one use of it, ``init``, runs
    jitted: flax's eager inits of the tiny DeepLab and translator take
    about 40 s on a CPU."""

    def __init__(self, model):
        self.init = jax.jit(model.init, static_argnames=("train",))


def _jax_setup(stage, K, opts, lr_warmup):
    model, opt, translator_apply, state = _jax_init(K, lr_warmup)
    cfg = JaxStepConfig(num_classes=K, crop_hw=CROP, tgt_stats_forward=True,
                        with_sharpness=stage != "dg", **opts)
    if stage == "dg":
        return state, jax.jit(jax_build_dg_step(model, opt, cfg))
    return state, jax.jit(jax_build_warmup_step(model, translator_apply, opt, cfg))


@functools.lru_cache(maxsize=None)
def _jax_init(K, lr_warmup):
    """(model, optimizer, translator_apply, initial state): one per class
    count and LR warm-up, shared by the stages (a JAX state is immutable)."""
    model = JaxDeepLabV2(num_classes=K, layers=LAYERS, droprate=0.0, s2b=False)
    k = jax.random.PRNGKey(3)
    x = jnp.zeros((1, *CROP, 3), jnp.float32)
    init = _JittedInit(model)
    variables = init.init({"params": k, "dropout": k}, x, train=False)
    sched = (jax_poly_warmup(LR, MAX_ITER, lr_warmup, 0.9) if lr_warmup
             else jax_poly(LR, MAX_ITER))
    opt = jax_sgd_grouped(sched, head_param_mask(variables["params"]), momentum=0.9,
                          weight_decay=5e-4)
    enc, dec = JaxEncoder(dim=8, n_downsample=2, n_res=1), JaxDecoder(dim=32, n_upsample=2, n_res=1)
    enc_p = jax.jit(enc.init)(k, x)["params"]
    dec_p = jax.jit(lambda key, p: dec.init(key, enc.apply({"params": p}, x)))(k, enc_p)["params"]

    def translator_apply(fz, img):
        return dec.apply({"params": fz["dec_s2t"]}, enc.apply({"params": fz["enc_s"]}, img))

    state = jax_create_state(init, opt, k, CROP, frozen={"enc_s": enc_p, "dec_s2t": dec_p})
    # frozen BN biases at +4 keep every backbone ReLU input off its kink
    # (tests/test_torch_port_train_step.py)
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
    return model, opt, translator_apply, state


def _port_setup(stage, jstate, K, opts, lr_warmup):
    student = DeepLabV2(num_classes=K, layers=LAYERS, droprate=0.0)
    student.load_state_dict(state_dict_from_jax(_np(jstate.params), _np(jstate.batch_stats),
                                                LAYERS), strict=True)
    sds = translator_state_dict_from_jax(_np(jstate.frozen))
    enc, dec = ImgEncoder(dim=8, n_downsample=2, n_res=1), ImgDecoder(dim=32, n_upsample=2, n_res=1)
    enc.load_state_dict(sds["enc_s"], strict=True)
    dec.load_state_dict(sds["dec_s2t"], strict=True)
    opt = sgd_grouped(student, LR, momentum=0.9, weight_decay=5e-4, head_mult=10.0)
    translator = None if stage == "dg" else torch.nn.ModuleDict({"enc_s": enc, "dec_s2t": dec})
    state = create_seg_state(student, opt, seed=0, translator=translator)
    state.teacher.load_state_dict(state_dict_from_jax(
        _np(jstate.teacher_params), _np(jstate.teacher_batch_stats), LAYERS), strict=True)
    cfg = StepConfig(num_classes=K, crop_hw=CROP, tgt_stats_forward=True,
                     with_sharpness=stage != "dg", compute_dtype=torch.float32, **opts)
    sched = (poly_warmup_schedule(LR, MAX_ITER, lr_warmup, 0.9) if lr_warmup
             else poly_schedule(LR, MAX_ITER))
    return state, (build_dg_step if stage == "dg" else build_warmup_step)(cfg, sched)


def make_batch(i, K):
    """Source images in the normalized range, labels over 7 of the K classes
    with a 4-row ignore band, and target images."""
    rr = np.random.default_rng(100 + i)
    s_lbl = rr.choice(rr.choice(K, size=7, replace=False), size=(B, *CROP)).astype(np.int32)
    s_lbl[:, :4] = 255
    return {"s_img": (rr.normal(size=(B, *CROP, 3)) * 0.5).astype(np.float32),
            "s_lbl": s_lbl,
            "t_img": (rr.normal(size=(B, *CROP, 3)) * 0.5).astype(np.float32)}


def snapshot_jax(jstate) -> dict:
    params = state_dict_from_jax(_np(jstate.params), _np(jstate.batch_stats), LAYERS)
    teacher = state_dict_from_jax(_np(jstate.teacher_params), _np(jstate.teacher_batch_stats),
                                  LAYERS)
    mu = state_dict_from_jax(_np(jstate.opt_state["mu"]), _np(jstate.batch_stats), LAYERS)
    return {"student": params, "teacher": teacher, "mu": mu}


def snapshot_port(state) -> dict:
    mu = {k: state.optimizer.state[p]["momentum_buffer"].clone()
          for k, p in state.student.named_parameters() if p.requires_grad}
    return {"student": copy.deepcopy(state.student.state_dict()),
            "teacher": copy.deepcopy(state.teacher.state_dict()), "mu": mu}


def run_steps(stage="warmup", K=19, lr_warmup=0, **opts) -> list[dict]:
    """5 warm-up (or DG) steps on both sides; ``opts`` are StepConfig fields
    that both packages' configs share (beta, seg_loss, photometric,
    p_jitter)."""
    opts = {"beta": 0.0, **opts}
    jstate, jstep = _jax_setup(stage, K, opts, lr_warmup)
    state, step = _port_setup(stage, jstate, K, opts, lr_warmup)
    draw = jax_kornia_draws if opts.get("photometric") == "kornia" else jax_diga_draws
    out = []
    for i in range(N_STEPS):
        batch = make_batch(i, K)
        # the warm-up step's key split (steps.py:205); DG's (:128) starts alike
        _, k_aug, k_mix, *_ = jax.random.split(jstate.rng, 6 if stage == "warmup" else 5)
        kw = {}
        if stage == "warmup":
            kw["selection"] = torch.from_numpy(np.array(
                jax_mixing.sample_half_classes(jnp.asarray(batch["s_lbl"]), k_mix, K)))
        if opts["beta"] > 0:
            kw["photometric_draws"] = draw(k_aug, B, opts.get("p_jitter", 0.5))
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()}, **kw)
        out.append({"jax": {k: float(v) for k, v in jmetrics.items()},
                    "port": {k: float(v) for k, v in metrics.items()},
                    "jax_state": snapshot_jax(jstate), "port_state": snapshot_port(state)})
    assert state.step == int(jstate.step) == N_STEPS
    return out


def _close(ours: torch.Tensor, ref, name):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL,
                               err_msg=name)


def check(trajectories, what: str) -> None:
    """One of ``WHAT`` agrees at every step; the student's head moved."""
    for i, t in enumerate(trajectories):
        if what == "metrics":
            assert set(t["port"]) == set(t["jax"]) == {"loss", "loss_semseg", "loss_distil"}
            for k, v in t["jax"].items():
                assert t["port"][k] == pytest.approx(v, rel=RTOL), (i, k)
            continue
        roles = {"momentum": ["mu"], "running_stats": ["student", "teacher"]}.get(what, [what])
        for role in roles:
            ours, ref = t["port_state"][role], t["jax_state"][role]
            keys = [k for k in ours if not k.endswith("num_batches_tracked")
                    and (role == "mu" or ("running" in k) == (what == "running_stats"))]
            assert keys
            for k in keys:
                _close(ours[k], ref[k], f"step {i} {role} {what} {k}")
    if what == "student":
        first, last = (t["port_state"]["student"]["final.head.1.weight"]
                       for t in (trajectories[0], trajectories[-1]))
        assert not torch.equal(first, last), "the student's head never moved"
