"""The port's self-training step against the jitted JAX step, over 5 steps.

The JAX side runs in a fresh process (``tests/_torch_port_selftrain_ref.py``:
its compile has grown past 100 GB late in a long pytest process) and
writes its initial state and each step's state to ``.npz`` files.  The
port starts from that state (tiny depth, crop 32x64, f32, ``beta=0``,
``droprate=0``, frozen BN biases at +4, random non-zero centroids) and
takes the same steps on the same batches, with the CrDoMix and DACS
selections the JAX step drew from its own key split injected.  After each
step these agree at atol 1e-5 / rtol 1e-4: the five metrics, the student's
and the teacher's parameters and BN running statistics, the SGD momentum,
and the centroid vectors and counts.
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-5, 1e-4
METRICS = ["loss", "loss_semseg", "loss_crossmix", "loss_distil", "consensus_kept"]


def _part(npz, prefix: str) -> dict[str, torch.Tensor]:
    return {k.split("|", 1)[1]: torch.from_numpy(npz[k]) for k in npz.files
            if k.startswith(prefix + "|")}


def _close(ours: torch.Tensor, want: torch.Tensor, name: str):
    np.testing.assert_allclose(ours.detach().numpy(), want.numpy(), atol=ATOL, rtol=RTOL,
                               err_msg=name)


def _port_setup(init):
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
                     lambda_distil=ref.LAMBDA_DISTIL, compute_dtype=torch.float32)
    return state, build_selftrain_step(cfg, poly_schedule(ref.LR, 1000))


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("selftrain_ref"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.path.join(REPO, "tests"), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tests",
                                                        "_torch_port_selftrain_ref.py"), out],
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    state, step = _port_setup(np.load(os.path.join(out, "init.npz")))
    steps = []
    for i in range(ref.N_STEPS):
        want = np.load(os.path.join(out, f"step{i}.npz"))
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
def test_metrics_match_every_step(trajectories, metric):
    for i, t in enumerate(trajectories):
        want = float(t["want"][f"metric|{metric}"])
        assert t["metrics"][metric] == pytest.approx(want, rel=RTOL, abs=ATOL), (i, metric)
    if metric == "consensus_kept":
        kept = [t["metrics"][metric] for t in trajectories]
        assert all(0.0 <= k <= 1.0 for k in kept) and max(kept) > 0.05, kept


@pytest.mark.parametrize("role", ["student", "teacher"])
@pytest.mark.parametrize("what", ["parameters", "running_stats"])
def test_model_state_matches_every_step(trajectories, role, what):
    for i, t in enumerate(trajectories):
        want = _part(t["want"], role)
        keys = [k for k in t[role] if not k.endswith("num_batches_tracked")
                and ("running" in k) == (what == "running_stats")]
        assert keys
        for k in keys:
            _close(t[role][k], want[k], f"step {i} {role} {k}")


def test_sgd_momentum_matches_every_step(trajectories):
    for i, t in enumerate(trajectories):
        want = _part(t["want"], "mu")
        assert t["mu"] and "layer0.1.weight" not in t["mu"]
        for k, v in t["mu"].items():
            _close(v, want[k], f"step {i} momentum {k}")


def test_centroids_match_every_step(trajectories):
    moved = False
    for i, t in enumerate(trajectories):
        want = _part(t["want"], "centroids")
        np.testing.assert_array_equal(t["centroids"].counts.numpy(), want["counts"].numpy(),
                                      err_msg=f"step {i} counts")
        _close(t["centroids"].vectors, want["vectors"], f"step {i} centroid vectors")
        moved |= bool((t["centroids"].counts > 150.0).any())
    assert moved, "no centroid was updated in 5 steps"
