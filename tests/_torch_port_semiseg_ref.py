"""JAX side of the semi-supervised step parities, run in a fresh process.

    python tests/_torch_port_semiseg_ref.py OUT_DIR

Builds the tiny HRNet+OCR of ``TINY`` (``diga_tpu.models.hrnet_ocr.W32``
patched to it in this process only), f32, ``droprate=0``, with perturbed
BN statistics and teacher, and runs the jitted ``diga_tpu`` semiseg steps
of the presets' recipe: ``N_STEPS`` warm-up steps (the DG step with the
0.1x OCR aux term, the RGB flip and the target-stats forward; beta 0.4)
and ``N_STEPS`` self-training steps without the translator (beta 0.3,
lambda_distil 0.25, random non-zero 32-d centroids), both from the same
initial model.  Each phase writes ``OUT_DIR/<phase>_init.npz`` (student,
teacher and, for self-training, the centroids) and
``OUT_DIR/<phase>_step<i>.npz``: the draws the step made from its own key
split (``steps.py:128,282-283``: the photometric factors, and for
self-training the target's and the DACS selection), the metrics, and the
state after the step (student, teacher, SGD momentum, centroids), keys
``<part>|<name>``.  The port's test starts from the init files, injects
the draws and compares.

One process for both phases: the JAX HRNet init is jitted once, and each
step's XLA compile (about 25 s for the warm-up, 40 s for self-training on
a CPU) stays out of the long pytest worker's memory.
"""

import sys
import types

import numpy as np

TINY = {
    "stem_channels": 8,
    "stage1_blocks": 1,
    "stage1_channels": 8,
    "stages": [
        (1, 1, (8, 16)),
        (1, 1, (8, 16, 32)),
        (1, 1, (8, 16, 32, 64)),
    ],
    "ocr_mid_channels": 32,
    "ocr_key_channels": 16,
}
K = 19
CROP = (32, 64)
# 8 images a side: at 32x64 the lowest branch runs at 1x2 pixels, so its
# train-mode BNs normalize 2·B·2 values, the DACS image's B·2; at B = 2
# that is 8 and 4 values and the f32 gradient through them is
# ill-conditioned (tests/test_torch_port_semiseg_step.py)
B = 8
LR = 1e-3  # the semiseg presets' (semiseg warm_up.py:86-96), poly power 1.0
MAX_ITER = 1000
N_STEPS = 5
FEAT_DIM = TINY["ocr_mid_channels"]
# StepConfig fields of each phase, from the semiseg presets
PHASES = {
    "warmup": dict(beta=0.4, lambda_distil=0.5, aux_weight=0.1, rgb_input=True,
                   use_crdomix=False, tgt_stats_forward=True),
    "selftrain": dict(beta=0.3, lambda_distil=0.25, aux_weight=0.1, rgb_input=True,
                      use_crdomix=False),
}
DRAW_KEYS = ("jitter", "brightness", "contrast", "saturation", "hue", "gray", "blur", "sharp",
             "sharp_factor")


def make_batch(i: int) -> dict:
    """Source and target images, source labels over 7 classes with an
    ignore band, target pseudo-labels over 3 classes with a 255 stripe."""
    rr = np.random.default_rng(500 + i)
    s_lbl = rr.choice(rr.choice(K, size=7, replace=False), size=(B, *CROP)).astype(np.int32)
    s_lbl[:, :4] = 255
    t_pseudo = rr.choice(rr.choice(K, size=3, replace=False), size=(B, *CROP)).astype(np.int32)
    t_pseudo[:, :, 20:28] = 255
    return {"s_img": (rr.normal(size=(B, *CROP, 3)) * 0.5).astype(np.float32),
            "s_lbl": s_lbl,
            "t_img": (rr.normal(size=(B, *CROP, 3)) * 0.5).astype(np.float32),
            "t_pseudo": t_pseudo}


def draws_from(npz, prefix: str) -> dict:
    """The photometric draws saved under ``prefix`` as torch tensors."""
    import torch

    return {k: torch.from_numpy(npz[f"{prefix}|{k}"]) for k in DRAW_KEYS}


def _flat(prefix: str, sd: dict) -> dict:
    return {f"{prefix}|{k}": np.asarray(v) for k, v in sd.items()}


def main(out_dir: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import diga_tpu.models.hrnet_ocr as H
    from diga_tpu.models.resnet_deeplab import head_param_mask
    from diga_tpu.ops import mixing
    from diga_tpu.ops.prototypes import Centroids
    from diga_tpu.train.optim import sgd_grouped
    from diga_tpu.train.schedules import poly_schedule
    from diga_tpu.train.state import create_seg_state
    from diga_tpu.train.steps import StepConfig, build_dg_step, build_selftrain_step
    from _torch_port_steps import jax_diga_draws
    from diga_tpu_torch.models.convert import hrnet_state_dict_from_jax

    H.W32 = TINY  # the JAX model reads its arch at call time (arch_name != "w48")
    model = H.HRNetOCR(num_classes=K, arch_name="tiny", droprate=0.0)
    k = jax.random.PRNGKey(3)
    x = jnp.zeros((1, *CROP, 3), jnp.float32)
    # create_seg_state's one use of its model is ``init``; eager it costs about 50 s
    init = types.SimpleNamespace(init=jax.jit(model.init, static_argnames=("train",)))
    variables = init.init({"params": k, "dropout": k}, x, train=False)
    opt = sgd_grouped(poly_schedule(LR, MAX_ITER, 1.0), head_param_mask(variables["params"]),
                      momentum=0.9, weight_decay=5e-4, head_mult=1.0)
    rr = np.random.default_rng(11)
    noisy = lambda tree, s: jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rr.normal(size=a.shape).astype(np.float32) * s, tree)

    def np_tree(tree):
        return jax.tree_util.tree_map(np.asarray, tree)

    def model_sd(params, stats):
        return hrnet_state_dict_from_jax(np_tree(params), np_tree(stats), TINY)

    def snapshot(st) -> dict:
        out = {**_flat("student", model_sd(st.params, st.batch_stats)),
               **_flat("teacher", model_sd(st.teacher_params, st.teacher_batch_stats))}
        if st.centroids is not None:
            out.update({"centroids|vectors": np.asarray(st.centroids.vectors),
                        "centroids|counts": np.asarray(st.centroids.counts)})
        return out

    base = create_seg_state(init, opt, k, CROP)
    params = jax.tree_util.tree_map(  # BN affine off its init, so its gradient shows
        lambda a: np.asarray(a) + (rr.normal(size=a.shape).astype(np.float32) * 0.1
                                   if a.ndim == 1 else 0.0), base.params)
    stats = jax.tree_util.tree_map(np.abs, noisy(base.batch_stats, 0.1))
    for phase, opts in PHASES.items():
        cents = None
        if phase == "selftrain":
            # random, non-zero centroids: with zero centroids every class is
            # equidistant and the consensus degenerates
            cents = Centroids(
                vectors=jnp.asarray(rr.normal(size=(K, FEAT_DIM)).astype(np.float32) * 0.5),
                counts=jnp.full((K,), 150.0, jnp.float32))
        state = create_seg_state(init, opt, k, CROP, centroids=cents)
        state = state.replace(
            params=params, batch_stats=stats, teacher_params=noisy(params, 0.01),
            teacher_batch_stats=jax.tree_util.tree_map(np.abs, noisy(stats, 0.01)))
        cfg = StepConfig(num_classes=K, crop_hw=CROP, **opts)
        if phase == "warmup":
            step = jax.jit(build_dg_step(model, opt, cfg))
        else:
            step = jax.jit(build_selftrain_step(model, lambda fz, img: img, opt, cfg))
        np.savez(f"{out_dir}/{phase}_init.npz", **snapshot(state))
        for i in range(N_STEPS):
            batch = make_batch(i)
            saved = {}
            if phase == "warmup":
                _, k_aug, *_ = jax.random.split(state.rng, 5)
                draws = {"photometric": jax_diga_draws(k_aug, B)}
            else:
                _, k_aug_s, k_aug_t, _, k_mix2, *_ = jax.random.split(state.rng, 9)
                draws = {"photometric": jax_diga_draws(k_aug_s, B),
                         "target_photometric": jax_diga_draws(k_aug_t, B)}
                saved["selection|dacs"] = np.asarray(
                    mixing.sample_half_classes(jnp.asarray(batch["s_lbl"]), k_mix2, K))
            for name, d in draws.items():
                saved.update({f"{name}|{kk}": v.numpy() for kk, v in d.items()})
            state, metrics = step(state, {kk: jnp.asarray(v) for kk, v in batch.items()})
            mu = model_sd(state.opt_state["mu"], state.batch_stats)
            np.savez(f"{out_dir}/{phase}_step{i}.npz", **snapshot(state), **saved,
                     **_flat("mu", mu),
                     **{f"metric|{kk}": np.asarray(v) for kk, v in metrics.items()})
            print(f"{phase} step {i}: "
                  + " ".join(f"{kk}={float(v):.6f}" for kk, v in metrics.items()), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
