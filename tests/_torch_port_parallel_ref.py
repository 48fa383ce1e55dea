"""JAX side of the data-parallel step parities, run in a fresh process.

    python tests/_torch_port_parallel_ref.py OUT_DIR

For each family of ``FAMILIES`` it builds the jitted ``diga_tpu`` step by
the composed-parity recipes (``tests/_torch_port_steps.py`` for the DG,
warm-up and SYNTHIA warm-up steps, ``tests/_torch_port_selftrain_ref.py``
for the self-training steps: tiny depth, f32, frozen BN biases at +4,
perturbed BN statistics and teacher, ``droprate=0``) and first writes
every family's initial state (``<init>_init.npz``, full) and every step's
draws from the step's own key split (``<family>_draws.pkl``: the CrDoMix
and DACS selections and the photometric draws, at the global batch of
``B`` = 2 images), then ``READY``.  The keys follow ``rng_{i+1} =
split(rng_i)[0]`` (``diga_tpu/train/steps.py:128,205,283``), so the draws
of every step are known before any step runs.  Then it takes ``N_STEPS``
steps of each family and writes ``<family>_step<i>.npz`` (the metrics and
the ``digest`` of the student, teacher and SGD momentum, and the
centroids), then ``DONE``.  The warm-up step, the flagship, is jitted over
``make_mesh(2)``: the state replicated, the batch sharded over 'data'.
"""

import os
import pickle
import sys

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import _torch_port_parallel_sub as sub  # noqa: E402
import _torch_port_selftrain_ref as st_ref  # noqa: E402
import _torch_port_steps as wu  # noqa: E402

N_STEPS = 2
# family: (init name, stage, classes, StepConfig options, LR warm-up)
FAMILIES = {
    "dg": ("deeplab19", "dg", 19, {"beta": 0.4}, 0),
    "warmup": ("deeplab19", "warmup", 19, {"beta": 0.4}, 0),
    "synthia": ("deeplab16", "warmup", 16,
                {"beta": 0.4, "p_jitter": 0.7, "seg_loss": "ohem"}, 3),
    "selftrain": ("selftrain", "selftrain", 19, {}, 0),
    "selftrain_fused": ("selftrain", "selftrain", 19, {"fuse_forwards": True}, 0),
}


def warmup_batch(i: int, k: int) -> dict:
    return wu.make_batch(i, k)


def selftrain_batch(i: int, k: int) -> dict:
    return st_ref.make_batch(i, k)


def _warmup_init(jstate) -> dict:
    snap = wu.snapshot_jax(jstate)
    sds = wu.translator_state_dict_from_jax(wu._np(jstate.frozen))
    out = {}
    for part in ("student", "teacher"):
        out.update({f"{part}|{k}": np.asarray(v) for k, v in snap[part].items()})
    for role in ("enc_s", "dec_s2t"):
        out.update({f"{role}|{k}": np.asarray(v) for k, v in sds[role].items()})
    return out


def _draws(stage: str, rng, batches: list[dict], k: int, opts: dict) -> list[dict]:
    """Each step's injected draws, from the key split the step makes."""
    out = []
    for batch in batches:
        if stage == "selftrain":
            keys = jax.random.split(rng, 9)
            sel = st_ref.selections(rng, batch["s_lbl"], k)
            out.append({"selection": sel["selection|crdomix"],
                        "dacs_selection": sel["selection|dacs"]})
        else:
            keys = jax.random.split(rng, 6 if stage == "warmup" else 5)
            drawn = {}
            if stage == "warmup":
                drawn["selection"] = np.array(wu.jax_mixing.sample_half_classes(
                    jnp.asarray(batch["s_lbl"]), keys[2], k))
            if opts.get("beta", 0.0) > 0:
                drawn["photometric_draws"] = {
                    name: v.numpy() for name, v in wu.jax_diga_draws(
                        keys[1], batch["s_img"].shape[0], opts.get("p_jitter", 0.5)).items()}
            out.append(drawn)
        rng = keys[0]
    return out


def main(out_dir: str) -> None:
    from diga_tpu.parallel import make_mesh, replicated, shard_batch

    setups = {}
    for name, (init_name, stage, k, opts, lr_warmup) in FAMILIES.items():
        if stage == "selftrain":
            jstate, jstep, snapshot, init = st_ref.setup("gta_fused" if "fused" in name else "gta")
            batches = [selftrain_batch(i, k) for i in range(N_STEPS)]
        else:
            jstate, jstep = wu._jax_setup(stage, k, {"beta": 0.0, **opts}, lr_warmup)
            snapshot, init = None, _warmup_init(jstate)
            batches = [warmup_batch(i, k) for i in range(N_STEPS)]
        path = os.path.join(out_dir, f"{init_name}_init.npz")
        if not os.path.exists(path):
            np.savez(path, **init)
        with open(os.path.join(out_dir, f"{name}_draws.pkl"), "wb") as f:
            pickle.dump(_draws(stage, jstate.rng, batches, k, opts), f)
        setups[name] = (jstate, jstep, snapshot, batches)
    open(os.path.join(out_dir, "READY"), "w").close()

    mesh = make_mesh(2)
    for name, (jstate, jstep, snapshot, batches) in setups.items():
        if name == "warmup":  # the flagship over a 2-device data mesh
            jstate = jax.device_put(jstate, replicated(mesh))
        for i, batch in enumerate(batches):
            jb = {kk: jnp.asarray(v) for kk, v in batch.items()}
            if name == "warmup":
                jb = shard_batch(batch, mesh)
            jstate, metrics = jstep(jstate, jb)
            if snapshot is None:
                snap = wu.snapshot_jax(jstate)
                parts = {**sub.digest(snap["student"], "student"),
                         **sub.digest(snap["teacher"], "teacher"), **sub.digest(snap["mu"], "mu")}
            else:
                full = snapshot(jstate)
                parts = {}
                for part in ("student", "teacher"):
                    parts.update(sub.digest({kk.split("|", 1)[1]: v for kk, v in full.items()
                                             if kk.startswith(part + "|")}, part))
                mu = wu.state_dict_from_jax(wu._np(jstate.opt_state["mu"]),
                                            wu._np(jstate.batch_stats), st_ref.LAYERS)
                parts.update(sub.digest(mu, "mu"))
                parts["centroids|vectors"] = full["centroids|vectors"].astype(np.float64).reshape(-1)
                parts["centroids|counts"] = full["centroids|counts"].astype(np.float64)
            np.savez(os.path.join(out_dir, f"{name}_step{i}.npz"), **parts,
                     **{f"metric|{kk}": np.asarray(v) for kk, v in metrics.items()})
        print(f"{name}: {N_STEPS} steps", flush=True)
        setups[name] = None
    open(os.path.join(out_dir, "DONE"), "w").close()


if __name__ == "__main__":
    main(sys.argv[1])
