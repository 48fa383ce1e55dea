"""The trainers and ``evaluate_val`` over processes on the CPU (gloo), and
the CLIs that stay on one device.

* ``train_dg --device cpu --n_devices 2`` (the tiny DG preset, 2 steps, an
  in-loop eval after step 1 sharded over the ranks): rank 0 alone writes
  ``metrics.jsonl`` (one record per logged step, one ``val/miou``),
  ``weights/``, ``ckpt_best/`` on a best above 0, and ``ckpt_final/``;
* ``--multihost`` outside torchrun's environment is refused; with that
  environment set for 2 processes (``tests/_torch_port_parallel_sub.py
  cli``, a TCP rendezvous on a free local port) it gives the losses of the
  ``--n_devices 2`` run;
* ``evaluate_val --n_devices 2`` over 3 val images (each rank dumps its
  own predictions): the scores and the dumped PNGs equal one process's;
* ``pseudolabel_generator``, ``calc_centroids``, ``soak``, ``parity_check``
  and ``train_domain_translator`` refuse both flags, as their JAX
  counterparts build no mesh.

Every spawned world has a join timeout and the group a timeout of its own
(``DIGA_TORCH_JOIN_TIMEOUT_S``, ``DIGA_TORCH_PG_TIMEOUT_S``).
"""

import json
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import _torch_port_parallel_sub as sub
from diga_tpu_torch.cli import (calc_centroids, evaluate_val, parity_check,
                                pseudolabel_generator, soak, train_dg,
                                train_domain_translator)
from diga_tpu_torch.configs import presets
from diga_tpu_torch.data import synthetic
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


@pytest.fixture(autouse=True)
def timeouts(monkeypatch):
    monkeypatch.setenv(dist.PG_TIMEOUT_ENV, "120")
    monkeypatch.setenv(dist.JOIN_TIMEOUT_ENV, "300")
    for k in dist.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_cli")
    gta = synthetic.make_gta5_fixture(str(root / "gta"), n=4, h=40, w=72)
    img, lbl = synthetic.make_cityscapes_fixture(str(root / "city"), n=4, h=40, w=72,
                                                 split="train")
    val_img, val_lbl = synthetic.make_cityscapes_fixture(str(root / "city"), n=3, h=40, w=72,
                                                         split="val")
    return {"root": root,
            "data": ["--source_root", str(root / "gta"), "--source_list", gta,
                     "--target_root", str(root / "city"), "--target_img_list", img,
                     "--target_lbl_list", lbl],
            "val": ["--val_img_list", val_img, "--val_lbl_list", val_lbl]}


@pytest.fixture(scope="module")
def world_run(fixtures, one_thread):
    """``train_dg --n_devices 2`` with an eval after step 1: (result, work dir)."""
    mp = pytest.MonkeyPatch()
    mp.setitem(presets.PRESETS, "tiny_dg", sub.tiny_dg_preset(eval_every=1))
    mp.setenv(dist.PG_TIMEOUT_ENV, "120")
    mp.setenv(dist.JOIN_TIMEOUT_ENV, "300")
    wd = str(fixtures["root"] / "wd_world")
    try:
        result = train_dg.main(["--preset", "tiny_dg", "--work_dir", wd, *fixtures["data"],
                                *fixtures["val"], "--eval_limit", "3", "--device", "cpu",
                                "--n_devices", "2"])
    finally:
        mp.undo()
    return result, wd


def test_n_devices_two_trains_and_rank_zero_alone_writes(world_run, capsys):
    result, wd = world_run
    assert set(result.last_metrics) == {"loss", "loss_semseg", "loss_distil"}
    assert all(math.isfinite(v) for v in result.last_metrics.values())
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    # one writer: one record of step 0 and one val/miou (two writers append two)
    assert [r["step"] for r in recs if "loss" in r] == [0]
    mious = [r["val/miou"] for r in recs if "val/miou" in r]
    assert len(mious) == 1 and 0.0 <= mious[0] <= 1.0
    assert result.best_miou == mious[0]
    assert os.path.exists(os.path.join(wd, "weights")) == (mious[0] > 0)
    assert os.path.exists(os.path.join(wd, "ckpt_best")) == (mious[0] > 0)
    assert torch.load(os.path.join(wd, "ckpt_final", "state.pth"))["step"] == 2
    assert sorted(os.listdir(os.path.join(wd, "ckpt_final"))) == ["state.pth", "student.pth",
                                                                  "teacher.pth"]


def test_multihost_without_torchrun_is_refused(fixtures, tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(presets.PRESETS, "tiny_dg", sub.tiny_dg_preset())
    with pytest.raises(SystemExit):
        train_dg.main(["--preset", "tiny_dg", "--work_dir", str(tmp_path / "wd"),
                       *fixtures["data"], "--device", "cpu", "--multihost"])
    assert "torchrun" in capsys.readouterr().err


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_multihost_ranks_give_the_losses_of_n_devices(fixtures, world_run, tmp_path):
    """Two processes, each one rank of a torchrun-style world, run what
    ``world_run`` ran."""
    ref, ref_wd = world_run
    out = str(tmp_path / "multihost.json")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.path.join(REPO, "tests"), os.environ.get("PYTHONPATH")) if p),
        WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    argv = ["--preset", "tiny_dg", "--work_dir", str(tmp_path / "mh"), *fixtures["data"],
            *fixtures["val"], "--eval_limit", "3", "--device", "cpu", "--multihost"]
    procs = [subprocess.Popen([sys.executable, os.path.join(REPO, "tests",
                                                            "_torch_port_parallel_sub.py"),
                               "cli", out, *argv],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    assert "rank 0 of world 2, backend gloo" in logs[0]
    with open(out) as f:
        got = json.load(f)
    assert got.keys() == ref.last_metrics.keys()
    for k, v in ref.last_metrics.items():
        assert got[k] == pytest.approx(v, rel=1e-6), k
    with open(os.path.join(ref_wd, "metrics.jsonl")) as f, \
            open(os.path.join(str(tmp_path / "mh"), "metrics.jsonl")) as g:
        a, b = [json.loads(x) for x in f], [json.loads(x) for x in g]
    assert len(a) == len(b) and all(
        ra.keys() == rb.keys() and all(ra[k] == pytest.approx(rb[k], rel=1e-6)
                                       for k in ra
                                       if k != "time" and "per_sec" not in k
                                       and not k.endswith("_ms"))
        for ra, rb in zip(a, b))


def test_evaluate_val_over_two_ranks_equals_one_process(fixtures, tmp_path, monkeypatch):
    monkeypatch.setitem(presets.PRESETS, "tiny_dg", sub.tiny_dg_preset())
    args = ["--preset", "tiny_dg", "--target_root", str(fixtures["root"] / "city"),
            *fixtures["val"], "--device", "cpu"]
    one = evaluate_val.main([*args, "--dump_preds", str(tmp_path / "one")])
    two = evaluate_val.main([*args, "--dump_preds", str(tmp_path / "two"), "--n_devices", "2"])
    assert one == two and math.isfinite(one["cityscapes"]["mean_iou"])
    names = sorted(os.listdir(tmp_path / "one"))
    assert len(names) == 3 and sorted(os.listdir(tmp_path / "two")) == names
    for n in names:
        np.testing.assert_array_equal(np.array(Image.open(tmp_path / "one" / n)),
                                      np.array(Image.open(tmp_path / "two" / n)))


@pytest.mark.parametrize("flags", [["--n_devices", "2"], ["--multihost"]],
                         ids=["n_devices", "multihost"])
@pytest.mark.parametrize("cli,args", [
    (pseudolabel_generator, ["--output_dir", "o"]),
    (calc_centroids, ["--centroid_dir", "c"]),
    (soak, ["--steps", "1"]),
    (parity_check, ["--weight_dir", "w"]),
    (train_domain_translator, []),
], ids=["pseudolabel_generator", "calc_centroids", "soak", "parity_check",
        "train_domain_translator"])
def test_clis_without_a_mesh_keep_refusing(cli, args, flags, capsys):
    with pytest.raises(SystemExit):
        cli.main(["--preset", "gta2city_warmup", "--device", "cpu", *args, *flags])
    assert "runs on one device" in capsys.readouterr().err
