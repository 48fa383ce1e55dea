"""Every train step family over a world of 2 gloo ranks on the CPU, 2 steps.

The rank layout is ``diga_tpu_torch/parallel/dist.py``'s: each rank holds
one image of each stream's global batch of 2 (the semiseg family 2 of 4),
and the global batch is the ranks' batches, rank by rank.  Both oracles see
that global batch:

  * the JAX step (``tests/_torch_port_parallel_ref.py``, a fresh process
    started first; the warm-up, the flagship, jitted over ``make_mesh(2)``)
    for the DG, warm-up, SYNTHIA warm-up (16 classes, OHEM, LR warm-up) and
    self-training steps, unfused and fused: the port's world starts from
    the JAX state and takes the draws the JAX step made from its own key
    split, each rank its rows;
  * the port's one-process step (no process group: ``nn.BatchNorm2d``, no
    collective) for those and for the semiseg HRNet+OCR step, the
    translator step, and a warm-up (kornia chain, channel dropout 0.1) and
    a fused self-training step (dropout 0.1) that draw everything from
    their own generators: the world draws at the global batch's shape and
    slices (``dist.draw_local``, ``batch_segments``).

After each step the metrics agree at rel 1e-4 (abs 1e-5; ``consensus_kept``,
a pixel share, within 1e-3), and the student's and the teacher's
parameters and BN running statistics, the SGD momentum and the centroids
at atol 1e-5 / rtol 1e-4, compared through
``_torch_port_parallel_sub.digest``.  The translator's six modules are held
as ``tests/test_torch_port_translator_train.py`` holds them (Adam moves a
parameter whose gradient is rounding noise by about lr whatever its
size): per module ‖Δp_world − Δp_one‖ / ‖Δp_one‖ <= 1e-3, the biases
before an InstanceNorm within Adam's bound.  The drawn families' frozen
BN biases and ASPP GroupNorm biases sit at +4, as in the parity recipes,
which keeps every ReLU input off its kink.  After the last step the parameters are equal on
both ranks.  The ranks
and the one-process runs pin torch to one thread each.
"""

import os
import pickle
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import _torch_port_parallel_sub as sub
import _torch_port_selftrain_ref as st_ref
import _torch_port_steps as wu
import test_torch_port_translator_train as TR
from diga_tpu_torch.parallel import dist


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch intra-op thread in this process and so in each rank it
    spawns (a rank gets its launcher's threads over the world size)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-5, 1e-4
N_STEPS = 2
WORLD = 2
JAX_FAMILIES = ("dg", "warmup", "synthia", "selftrain", "selftrain_fused")
PORT_FAMILIES = ("semiseg", "translator", "warmup_drawn", "selftrain_fused_drawn")
METRICS = {"dg": ["loss", "loss_semseg", "loss_distil"],
           "selftrain": ["loss", "loss_semseg", "loss_crossmix", "loss_distil",
                         "consensus_kept"],
           "translator": ["loss_g", "loss_d_s2t", "loss_d_t2s", "loss_adv", "loss_cyc",
                          "loss_edge", "loss_self"]}


def _metrics_of(family: str) -> list[str]:
    if family == "translator":
        return METRICS["translator"]
    return METRICS["selftrain" if family.startswith("selftrain") else "dg"]


def _spec(family: str, out: str | None = None) -> dict:
    """The port's build and batches of ``family`` (``sub.build_family``)."""
    deeplab = {"kind": "deeplab", "droprate": 0.0, "lr": 2.5e-4}
    warm = {"tgt_stats_forward": True, "beta": 0.4}
    if family in JAX_FAMILIES:
        init, stage, k, opts, lr_warmup = __import__("_torch_port_parallel_ref").FAMILIES[family]
        with open(os.path.join(out, f"{family}_draws.pkl"), "rb") as f:
            inject = pickle.load(f)
        spec = {**deeplab, "stage": stage, "K": k, "lr_warmup": lr_warmup,
                "init": os.path.join(out, f"{init}_init.npz"), "inject": inject}
        if stage == "selftrain":
            spec["opts"] = {"beta": 0.0, "lambda_distil": st_ref.LAMBDA_DISTIL, **opts}
            spec["batches"] = [st_ref.make_batch(i, k) for i in range(N_STEPS)]
        else:
            spec["opts"] = {**warm, "with_sharpness": stage != "dg", **opts}
            spec["batches"] = [wu.make_batch(i, k) for i in range(N_STEPS)]
        return spec
    if family == "semiseg":
        rr = np.random.default_rng(21)
        batches = [{"s_img": (rr.normal(size=(4, *sub.CROP, 3)) * 0.5).astype(np.float32),
                    "s_lbl": rr.integers(0, 19, size=(4, *sub.CROP)).astype(np.int32),
                    "t_img": (rr.normal(size=(4, *sub.CROP, 3)) * 0.5).astype(np.float32)}
                   for _ in range(N_STEPS)]
        return {"kind": "hrnet", "stage": "dg", "K": 19, "droprate": 0.05, "lr": 1e-3,
                "power": 1.0, "head_mult": 1.0, "batches": batches,
                "opts": {**warm, "with_sharpness": False, "aux_weight": 0.1,
                         "rgb_input": True}}
    if family == "translator":
        # the translator parity's batches: with labels drawn per pixel the
        # seg-edge term's gradient is rounding noise in many weights, and
        # the second Adam step moves them apart between two thread counts
        return {"kind": "translator", "batches": [TR._batch(i) for i in range(N_STEPS)],
                "max_iter": TR.MAX_ITER}
    if family == "warmup_drawn":
        return {**deeplab, "droprate": 0.1, "stage": "warmup", "K": 19, "seed": 4, "bn_bias": 4.0,
                "batches": [wu.make_batch(20 + i, 19) for i in range(N_STEPS)],
                "opts": {**warm, "photometric": "kornia"}}
    assert family == "selftrain_fused_drawn"
    return {**deeplab, "droprate": 0.1, "stage": "selftrain", "K": 19, "seed": 4,
            "bn_bias": 4.0, "feat_dim": 256, "batches": [st_ref.make_batch(20 + i) for i in range(N_STEPS)],
            "opts": {"beta": 0.3, "lambda_distil": 0.25, "fuse_forwards": True}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, monkeypatch_module, one_thread):
    out = str(tmp_path_factory.mktemp("parallel_ref"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.path.join(REPO, "tests"), os.environ.get("PYTHONPATH")) if p))
    log = open(os.path.join(out, "ref.log"), "w")
    ref = subprocess.Popen([sys.executable, os.path.join(REPO, "tests",
                                                         "_torch_port_parallel_ref.py"), out],
                           stdout=log, stderr=subprocess.STDOUT, env=env)
    try:
        # the port-only families on one process while the JAX side compiles
        specs = {f: _spec(f) for f in PORT_FAMILIES}
        one = sub.run_families(specs)
        deadline = time.monotonic() + 600
        while not os.path.exists(os.path.join(out, "READY")):
            assert ref.poll() is None, open(os.path.join(out, "ref.log")).read()
            assert time.monotonic() < deadline, "the JAX reference never wrote its inits"
            time.sleep(0.5)
        jax_specs = {f: _spec(f, out) for f in JAX_FAMILIES}
        specs.update(jax_specs)
        world: dict = {}

        def run_world():
            try:
                world["out"] = dist.launch(sub.run_families, WORLD, "cpu", (specs,),
                                           join_timeout_s=600)
            except BaseException as e:  # noqa: BLE001 - raised below, in the test's thread
                world["error"] = e

        thread = threading.Thread(target=run_world)
        thread.start()
        one.update(sub.run_families(jax_specs))
        thread.join()
        if "error" in world:
            raise world["error"]
        assert ref.wait(timeout=600) == 0, open(os.path.join(out, "ref.log")).read()
    finally:
        if ref.poll() is None:
            ref.kill()
        log.close()
    jax = {f: [dict(np.load(os.path.join(out, f"{f}_step{i}.npz"))) for i in range(N_STEPS)]
           for f in JAX_FAMILIES}
    shutil.rmtree(out, ignore_errors=True)  # the initial states take about 750 MB
    return {"world": world["out"], "one": one, "jax": jax}


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    # a hung collective fails the fixture at the group's timeout, not the run
    mp.setenv(dist.PG_TIMEOUT_ENV, "300")
    yield mp
    mp.undo()


def _whats(family: str) -> list[str]:
    if family == "translator":
        return ["metrics", "modules"]
    out = ["metrics", "student", "teacher", "running_stats", "momentum"]
    return out + (["centroids"] if family.startswith("selftrain") else [])


def _close(ours, want, name):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(want), atol=ATOL, rtol=RTOL,
                               err_msg=name)


def _noise_parameters() -> set[tuple[str, str]]:
    """(role, name) of the conv biases right before an InstanceNorm: their
    gradient is zero in exact arithmetic, so Adam moves them by about lr
    in the sign of rounding noise (tests/test_torch_port_translator_train.py)."""
    from diga_tpu_torch.models.translator import Conv2dBlock, SubpixelUpBlock

    mods = sub.translator_modules()
    return {(r, f"{n}.conv.bias") for r, mod in mods.items() for n, m in mod.named_modules()
            if isinstance(m, SubpixelUpBlock) or (isinstance(m, Conv2dBlock) and m.norm == "in")}


def _check_translator(ours: list[dict], want: list[dict]) -> None:
    """As the translator parity holds its parameters: per module
    ‖Δp_world − Δp_one‖ / ‖Δp_one‖ <= ``TR.TOL`` (Δp = p_t − p_0), each
    noise parameter within ``TR.adam_bound`` of the other run's."""
    noise = _noise_parameters()
    for k in want[0]:
        if k != "metrics":
            np.testing.assert_array_equal(ours[0][k], want[0][k], err_msg=f"initial {k}")
    for i in range(1, len(ours)):
        for role in TR.ROLES:
            num = den = 0.0
            for k in (k for k in want[i] if k.split("|")[0] == role):
                diff = ours[i][k] - want[i][k]
                if (role, k.split("|", 1)[1]) in noise:
                    assert np.abs(diff).max() <= TR.adam_bound(i), (i, k)
                else:
                    num += float(np.square(diff).sum())
                    den += float(np.square(want[i][k] - want[0][k]).sum())
            assert den > 0 and np.sqrt(num / den) <= TR.TOL, (i, role, np.sqrt(num / den))


def _check(family: str, what: str, ours: list[dict], want: list[dict], want_is_jax: bool):
    """``ours`` (the initial snapshot, then each step's) against ``want``
    (the JAX steps', or the one-process run's snapshots likewise)."""
    if what == "modules":
        return _check_translator(ours, want)
    ours, want = ours[1:], (want if want_is_jax else want[1:])
    assert len(ours) == len(want) == N_STEPS
    for i, (o, w) in enumerate(zip(ours, want)):
        if what == "metrics":
            for m in _metrics_of(family):
                ref_v = float(w[f"metric|{m}"]) if want_is_jax else w["metrics"][m]
                # consensus_kept, a pixel share, within 1e-3 (33 of the 32,768
                # target pixels), as tests/test_torch_port_semiseg_step.py
                # bounds it: a pixel whose class distances tie to f32 rounding
                # flips with the order of a sum
                atol = 1e-3 if m == "consensus_kept" else ATOL
                assert o["metrics"][m] == pytest.approx(ref_v, rel=RTOL, abs=atol), (i, m)
            continue
        if what == "centroids":
            np.testing.assert_array_equal(o["centroids|counts"], w["centroids|counts"])
            _close(o["centroids|vectors"], w["centroids|vectors"], f"step {i} centroids")
            continue
        prefixes = {"momentum": ("mu",),
                    "running_stats": ("student", "teacher")}.get(what, (what,))
        keys = [k for k in o if k.split("|")[0] in prefixes
                and (what == "momentum" or ("running" in k) == (what == "running_stats"))]
        assert keys, (family, what)
        for k in keys:
            _close(o[k], w[k], f"step {i} {family} {k}")


@pytest.mark.parametrize("family,what", [(f, w) for f in JAX_FAMILIES for w in _whats(f)])
def test_world_matches_the_jax_step_on_the_global_batch(runs, family, what):
    _check(family, what, runs["world"][family]["steps"], runs["jax"][family], True)


@pytest.mark.parametrize("family,what",
                         [(f, w) for f in JAX_FAMILIES + PORT_FAMILIES for w in _whats(f)])
def test_world_matches_the_one_process_step_on_the_global_batch(runs, family, what):
    _check(family, what, runs["world"][family]["steps"], runs["one"][family]["steps"], False)


@pytest.mark.parametrize("family", JAX_FAMILIES + PORT_FAMILIES)
def test_parameters_equal_on_every_rank(runs, family):
    assert runs["world"][family]["equal_on_every_rank"]
