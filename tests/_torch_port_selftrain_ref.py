"""JAX side of the self-training step parity, run in a fresh process.

    python tests/_torch_port_selftrain_ref.py OUT_DIR [VARIANT]

VARIANT is a key of ``VARIANTS``: ``gta`` (the default: 19 classes, CE),
``synthia`` (16 classes, OHEM on the source and the DACS image) or
``gta_fused`` (``gta`` with ``fuse_forwards``: one teacher and one student
forward a step over the concatenated batches).

Builds the jitted ``diga_tpu`` self-training step by the composed-parity
recipe (tiny depth, f32, ``beta=0``, ``droprate=0``, frozen BN biases at
+4, perturbed BN statistics and teacher, random non-zero centroids) and
runs ``N_STEPS`` steps on the batches of ``make_batch``.  Writes
``OUT_DIR/init.npz`` (the initial student, teacher, translator and
centroids) and ``OUT_DIR/step<i>.npz`` (the CrDoMix and DACS selections
drawn from the step's own key split, ``steps.py:282-283``, the metrics,
and the state after the step), keys ``<part>|<name>``.

The self-training step's XLA compile has grown past 100 GB late in a long
pytest process (tests/test_e2e_selftrain.py:86-88); a fresh process
compiles it in a few GB, so the test runs this file as a subprocess.
"""

import functools
import re
import sys
import types

import numpy as np

K = 19
LAYERS = (1, 1, 1, 1)
CROP = (32, 64)
B = 2
LR = 2.5e-4
LAMBDA_DISTIL = 0.25
N_STEPS = 5
FEAT_DIM = 256
TRANSLATOR = {"enc": dict(dim=8, n_downsample=2, n_res=1),
              "dec": dict(dim=32, n_upsample=2, n_res=1)}
# each variant's class count, StepConfig fields and the initial bias of the
# ASPP branches' GroupNorms (None: as initialized).  SYNTHIA: OHEM at the
# presets' thresh 0.7 and min_kept 100 000; its GroupNorm biases at +4 keep
# the head's ReLU inputs off their kink, as the frozen BN biases do in the
# backbone (at 0, one ReLU input of the d24 branch sat within f32 rounding
# of 0 and flipped between the packages at step 0)
VARIANTS = {"gta": {"num_classes": K, "step": {}, "aspp_gn_bias": None},
            "synthia": {"num_classes": 16, "step": {"seg_loss": "ohem"}, "aspp_gn_bias": 4.0},
            "gta_fused": {"num_classes": K, "step": {"fuse_forwards": True},
                          "aspp_gn_bias": None}}


def make_batch(i: int, num_classes: int = K) -> dict:
    """Source and target images, source labels with an ignore band, and
    target pseudo-labels over a few classes with a 255 stripe."""
    rr = np.random.default_rng(300 + i)
    classes = rr.choice(num_classes, size=7, replace=False)
    s_lbl = rr.choice(classes, size=(B, *CROP)).astype(np.int32)
    s_lbl[:, :4] = 255
    classes = rr.choice(num_classes, size=3, replace=False)
    t_pseudo = rr.choice(classes, size=(B, *CROP)).astype(np.int32)
    t_pseudo[:, :, 20:28] = 255
    return {"s_img": (rr.normal(size=(B, *CROP, 3)) * 0.5).astype(np.float32),
            "s_lbl": s_lbl,
            "t_img": (rr.normal(size=(B, *CROP, 3)) * 0.5).astype(np.float32),
            "t_pseudo": t_pseudo}


def _flat(prefix: str, sd: dict) -> dict:
    return {f"{prefix}|{k}": np.asarray(v) for k, v in sd.items()}


def setup(variant: str = "gta"):
    """(jax state, jitted step, snapshot(state) -> {key: array}, the initial
    arrays of ``init.npz``) of ``variant``."""
    import jax

    from diga_tpu.train.steps import StepConfig, build_selftrain_step

    K, step_opts = VARIANTS[variant]["num_classes"], VARIANTS[variant]["step"]
    model, opt, translator_apply, state, snapshot, init = _initial_state(
        K, VARIANTS[variant]["aspp_gn_bias"])
    cfg = StepConfig(num_classes=K, crop_hw=CROP, beta=0.0, lambda_distil=LAMBDA_DISTIL,
                     **step_opts)
    step = jax.jit(build_selftrain_step(model, translator_apply, opt, cfg))
    return state, step, snapshot, init


@functools.lru_cache(maxsize=None)
def _initial_state(K: int, aspp_gn_bias):
    """(model, optimizer, translator_apply, state, snapshot, init arrays),
    shared by the variants of one class count and GroupNorm bias."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from diga_tpu.models.resnet_deeplab import DeepLabV2, head_param_mask
    from diga_tpu.models.translator import ImgDecoder, ImgEncoder
    from diga_tpu.ops.prototypes import Centroids
    from diga_tpu.train.optim import sgd_grouped
    from diga_tpu.train.schedules import poly_schedule
    from diga_tpu.train.state import create_seg_state
    from diga_tpu_torch.models.convert import state_dict_from_jax, translator_state_dict_from_jax

    def np_tree(tree):
        return jax.tree_util.tree_map(np.asarray, tree)

    model = DeepLabV2(num_classes=K, layers=LAYERS, droprate=0.0, s2b=False)
    k = jax.random.PRNGKey(3)
    x = jnp.zeros((1, *CROP, 3), jnp.float32)
    # flax's eager inits take about 40 s on a CPU; jitted, a few seconds.
    # create_seg_state's one use of its model is ``init``.
    init = types.SimpleNamespace(init=jax.jit(model.init, static_argnames=("train",)))
    variables = init.init({"params": k, "dropout": k}, x, train=False)
    opt = sgd_grouped(poly_schedule(LR, 1000), head_param_mask(variables["params"]),
                      momentum=0.9, weight_decay=5e-4)
    enc, dec = ImgEncoder(**TRANSLATOR["enc"]), ImgDecoder(**TRANSLATOR["dec"])
    enc_p = jax.jit(enc.init)(k, x)["params"]
    dec_p = jax.jit(lambda key, p: dec.init(key, enc.apply({"params": p}, x)))(k, enc_p)["params"]

    def translator_apply(fz, img):
        return dec.apply({"params": fz["dec_s2t"]}, enc.apply({"params": fz["enc_s"]}, img))

    rr = np.random.default_rng(11)
    # random, non-zero centroids: with zero centroids every class is
    # equidistant and the consensus degenerates
    cents = Centroids(vectors=jnp.asarray(rr.normal(size=(K, FEAT_DIM)).astype(np.float32) * 0.1),
                      counts=jnp.full((K,), 150.0, jnp.float32))
    state = create_seg_state(init, opt, k, CROP, centroids=cents,
                             frozen={"enc_s": enc_p, "dec_s2t": dec_p})
    # frozen BN biases at +4 keep every backbone ReLU input off its kink
    # (tests/test_torch_port_train_step.py)
    def init_value(path, a):
        name = jax.tree_util.keystr(path)
        if "frozen_bn" in name and name.endswith("['bias']"):
            return np.full_like(a, 4.0)
        if aspp_gn_bias is not None and re.fullmatch(r"\['head'\]\['branch\d_gn'\]\['bias'\]",
                                                     name):
            return np.full_like(a, aspp_gn_bias)
        return np.asarray(a)

    state = state.replace(params=jax.tree_util.tree_map_with_path(init_value, state.params))
    noisy = lambda tree, s: jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rr.normal(size=a.shape).astype(np.float32) * s, tree)
    state = state.replace(
        batch_stats=jax.tree_util.tree_map(np.abs, noisy(state.batch_stats, 0.01)),
        teacher_batch_stats=jax.tree_util.tree_map(np.abs, noisy(state.batch_stats, 0.01)),
        teacher_params=noisy(state.params, 0.01))

    def snapshot(st) -> dict:
        return {**_flat("student", state_dict_from_jax(np_tree(st.params),
                                                       np_tree(st.batch_stats), LAYERS)),
                **_flat("teacher", state_dict_from_jax(np_tree(st.teacher_params),
                                                       np_tree(st.teacher_batch_stats), LAYERS)),
                "centroids|vectors": np.asarray(st.centroids.vectors),
                "centroids|counts": np.asarray(st.centroids.counts)}

    sds = translator_state_dict_from_jax({"enc_s": np_tree(enc_p), "dec_s2t": np_tree(dec_p)})
    init = {**snapshot(state), **_flat("enc_s", sds["enc_s"]), **_flat("dec_s2t", sds["dec_s2t"])}
    return model, opt, translator_apply, state, snapshot, init


def selections(rng, s_lbl: np.ndarray, num_classes: int) -> dict:
    """The CrDoMix and DACS selections the step draws from ``rng`` (its key
    split, ``steps.py:282-283``)."""
    import jax
    import jax.numpy as jnp

    from diga_tpu.ops import mixing

    _, _, _, k_mix1, k_mix2, _, _, _, _ = jax.random.split(rng, 9)
    lbl = jnp.asarray(s_lbl)
    return {"selection|crdomix": np.asarray(mixing.sample_half_classes(lbl, k_mix1, num_classes)),
            "selection|dacs": np.asarray(mixing.sample_half_classes(lbl, k_mix2, num_classes))}


def main(out_dir: str, variant: str = "gta") -> None:
    import jax
    import jax.numpy as jnp

    from diga_tpu_torch.models.convert import state_dict_from_jax

    K = VARIANTS[variant]["num_classes"]
    state, step, snapshot, init = setup(variant)
    np.savez(f"{out_dir}/init.npz", **init)
    for i in range(N_STEPS):
        batch = make_batch(i, K)
        drawn = selections(state.rng, batch["s_lbl"], K)
        state, metrics = step(state, {kk: jnp.asarray(v) for kk, v in batch.items()})
        np_tree = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
        mu = state_dict_from_jax(np_tree(state.opt_state["mu"]), np_tree(state.batch_stats), LAYERS)
        np.savez(f"{out_dir}/step{i}.npz", **snapshot(state), **drawn, **_flat("mu", mu),
                 **{f"metric|{kk}": np.asarray(v) for kk, v in metrics.items()})
        print(f"step {i}: " + " ".join(f"{kk}={float(v):.6f}" for kk, v in metrics.items()),
              flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:])
