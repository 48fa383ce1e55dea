"""The self-training step's ``fuse_forwards`` mode against JAX's fused step.

The JAX side runs in a fresh process (``tests/_torch_port_selftrain_ref.py
OUT gta_fused``: the ``gta`` recipe with ``StepConfig(fuse_forwards=True)``)
and writes its initial state and each step's state; the port takes the
same 5 steps from that state with ``fuse_forwards`` on and the CrDoMix and
DACS selections the JAX step drew injected.  After each step the metrics,
the student's and the teacher's parameters and BN running statistics, the
SGD momentum and the centroids agree at the unfused parity's atol 1e-5 /
rtol 1e-4 (``tests/test_torch_port_selftrain_step.py``).

The mode's documented deviation, stated as a test: one fused step runs the
teacher once, on [source; mix; target], and its BN running statistics are
those of a single train-mode forward over that concatenated batch; the
student runs once, on [source; mix; DACS image].
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_port_selftrain_ref as ref
from diga_tpu_torch.models.resnet_deeplab import DeepLabV2
from diga_tpu_torch.models.translator import ImgDecoder, ImgEncoder
from diga_tpu_torch.ops.prototypes import Centroids
from diga_tpu_torch.train.optim import sgd_grouped
from diga_tpu_torch.train.schedules import poly_schedule
from diga_tpu_torch.train.state import create_seg_state
from diga_tpu_torch.train.steps import StepConfig, build_selftrain_step
from test_torch_port_selftrain_step import METRICS, RTOL, ATOL, _close, _part

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on one host, and
    these small models' many small ops only contend across more."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fused_setup(init, fuse: bool = True):
    student = DeepLabV2(num_classes=ref.K, layers=ref.LAYERS, droprate=0.0)
    student.load_state_dict(_part(init, "student"), strict=True)
    enc, dec = ImgEncoder(**ref.TRANSLATOR["enc"]), ImgDecoder(**ref.TRANSLATOR["dec"])
    enc.load_state_dict(_part(init, "enc_s"), strict=True)
    dec.load_state_dict(_part(init, "dec_s2t"), strict=True)
    opt = sgd_grouped(student, ref.LR, momentum=0.9, weight_decay=5e-4, head_mult=10.0)
    cents = _part(init, "centroids")
    state = create_seg_state(student, opt, seed=0,
                             translator=torch.nn.ModuleDict({"enc_s": enc, "dec_s2t": dec}),
                             centroids=Centroids(cents["vectors"], cents["counts"]))
    state.teacher.load_state_dict(_part(init, "teacher"), strict=True)
    cfg = StepConfig(num_classes=ref.K, crop_hw=ref.CROP, beta=0.0,
                     lambda_distil=ref.LAMBDA_DISTIL, compute_dtype=torch.float32,
                     fuse_forwards=fuse)
    return state, build_selftrain_step(cfg, poly_schedule(ref.LR, 1000))


@pytest.fixture(scope="module")
def fused_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("selftrain_fused_ref"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.path.join(REPO, "tests"), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tests",
                                                        "_torch_port_selftrain_ref.py"),
                           out, "gta_fused"], capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return out


@pytest.fixture(scope="module")
def trajectories(fused_run):
    state, step = _fused_setup(np.load(os.path.join(fused_run, "init.npz")))
    steps = []
    for i in range(ref.N_STEPS):
        want = np.load(os.path.join(fused_run, f"step{i}.npz"))
        metrics = step(state, {k: torch.from_numpy(v) for k, v in ref.make_batch(i).items()},
                       selection=torch.from_numpy(want["selection|crdomix"]),
                       dacs_selection=torch.from_numpy(want["selection|dacs"]))
        mu = {k: state.optimizer.state[p]["momentum_buffer"].clone()
              for k, p in state.student.named_parameters() if p.requires_grad}
        steps.append({"want": want, "metrics": {k: float(v) for k, v in metrics.items()},
                      "student": copy.deepcopy(state.student.state_dict()),
                      "teacher": copy.deepcopy(state.teacher.state_dict()), "mu": mu,
                      "centroids": copy.deepcopy(state.centroids)})
    assert state.step == ref.N_STEPS
    return steps


@pytest.mark.parametrize("metric", METRICS)
def test_fused_metrics_match_jax_every_step(trajectories, metric):
    for i, t in enumerate(trajectories):
        want = float(t["want"][f"metric|{metric}"])
        assert t["metrics"][metric] == pytest.approx(want, rel=RTOL, abs=ATOL), (i, metric)


@pytest.mark.parametrize("role", ["student", "teacher"])
@pytest.mark.parametrize("what", ["parameters", "running_stats"])
def test_fused_model_state_matches_jax_every_step(trajectories, role, what):
    for i, t in enumerate(trajectories):
        want = _part(t["want"], role)
        keys = [k for k in t[role] if not k.endswith("num_batches_tracked")
                and ("running" in k) == (what == "running_stats")]
        assert keys
        for k in keys:
            _close(t[role][k], want[k], f"step {i} {role} {k}")


def test_fused_sgd_momentum_and_centroids_match_jax_every_step(trajectories):
    for i, t in enumerate(trajectories):
        want = _part(t["want"], "mu")
        assert t["mu"]
        for k, v in t["mu"].items():
            _close(v, want[k], f"step {i} momentum {k}")
        want = _part(t["want"], "centroids")
        np.testing.assert_array_equal(t["centroids"].counts.numpy(), want["counts"].numpy(),
                                      err_msg=f"step {i} counts")
        _close(t["centroids"].vectors, want["vectors"], f"step {i} centroid vectors")


def test_fused_step_differs_from_the_unfused_one(fused_run, trajectories):
    """The pooled BN statistics make the fused step another function: its
    first loss leaves the unfused step's on the same state and batch."""
    state, step = _fused_setup(np.load(os.path.join(fused_run, "init.npz")), fuse=False)
    want = trajectories[0]["want"]
    m = step(state, {k: torch.from_numpy(v) for k, v in ref.make_batch(0).items()},
             selection=torch.from_numpy(want["selection|crdomix"]),
             dacs_selection=torch.from_numpy(want["selection|dacs"]))
    assert abs(float(m["loss"]) - trajectories[0]["metrics"]["loss"]) > 1e-4


def test_one_fused_step_is_one_forward_per_model_over_the_concatenated_batch(fused_run):
    state, step = _fused_setup(np.load(os.path.join(fused_run, "init.npz")))
    want = np.load(os.path.join(fused_run, "step0.npz"))
    batch = {k: torch.from_numpy(v) for k, v in ref.make_batch(0).items()}
    calls = {"teacher": [], "student": []}

    def record(role):
        def hook(module, args):
            # the module as the forward finds it: EMA'd parameters, BN
            # statistics not yet updated
            calls[role].append((args[0].detach().clone(), copy.deepcopy(module)))
        return hook

    handles = [getattr(state, r).register_forward_pre_hook(record(r)) for r in calls]
    try:
        step(state, batch, selection=torch.from_numpy(want["selection|crdomix"]),
             dacs_selection=torch.from_numpy(want["selection|dacs"]))
    finally:
        for h in handles:
            h.remove()
    b, bt = batch["s_img"].shape[0], batch["t_img"].shape[0]
    assert [len(c) for c in calls.values()] == [1, 1]
    (x_t, teacher0), = calls["teacher"]
    (x_s, _), = calls["student"]
    assert x_t.shape[0] == 2 * b + bt and x_s.shape[0] == 2 * b + bt
    nhwc = lambda x: x.permute(0, 2, 3, 1)  # noqa: E731
    assert torch.equal(nhwc(x_t)[:b], batch["s_img"]) and torch.equal(nhwc(x_s)[:b],
                                                                       batch["s_img"])
    assert torch.equal(nhwc(x_t)[-bt:], batch["t_img"])
    with torch.no_grad():
        teacher0(x_t)  # one train-mode forward over [source; mix; target]
    ours = state.teacher.state_dict()
    stats = [k for k in ours if "running" in k]
    assert stats
    for k in stats:
        torch.testing.assert_close(ours[k], teacher0.state_dict()[k], rtol=0, atol=0,
                                   msg=f"teacher {k}")
