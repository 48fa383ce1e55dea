"""The port's warm-up trainer CLI on synthetic fixtures (CPU).

``diga_tpu_torch.cli.train_warm_up.main`` runs 2 steps of a tiny
registered preset (layers (1, 1, 1, 1), crop 32x64, f32) on synthetic
GTA5 and Cityscapes fixtures with ``--device cpu``: finite ``loss=`` lines,
a ``metrics.jsonl``, and ``student.pth``/``teacher.pth`` that load into the
port's eval model with ``strict=True``.  The weight directories are the JAX
trainer's (``diga_tpu/cli/train_seg.py:95-117``): ``<work_dir>/weights`` and
the full-state ``<work_dir>/ckpt_best`` only on a new best mIoU, the last
step's full state in ``<work_dir>/ckpt_final``.  Without ``--device cpu``
it raises here (the default is the card), and the flags it cannot honour
are refused.
"""

import copy
import dataclasses
import json
import math
import os
import re
import shutil

import pytest
import torch

import diga_tpu_torch.cli.train_seg as train_seg
import diga_tpu_torch.cli.train_warm_up as cli
from diga_tpu_torch.configs import presets
from diga_tpu_torch.data import synthetic
from diga_tpu_torch.train import loop
from diga_tpu_torch.train.build import build_eval
from diga_tpu_torch.train.state import reference_state_dict

LAYERS = (1, 1, 1, 1)


@pytest.fixture()
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed after the test: the checkpoints these
    tests write at the reference translator widths take hundreds of MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _tiny():
    base = presets.get_preset("gta2city_warmup")
    return dataclasses.replace(
        base,
        data=dataclasses.replace(
            base.data, num_workers=1,
            source_streams=(presets.LoaderSpec("gta5", (40, 72), 1),
                            presets.LoaderSpec("gta5", (48, 80), 1)),
            target_streams=(presets.LoaderSpec("cityscapes", (40, 72), 1),
                            presets.LoaderSpec("cityscapes", (48, 80), 1))),
        train=dataclasses.replace(base.train, crop_hw=(32, 64), compute_dtype="float32",
                                  num_steps=2, eval_every=0),
        eval=presets.EvalConfig(out_hw=(40, 72), ds_hw=(20, 36)),
        extra={"layers": LAYERS})


@pytest.fixture()
def argv(tmp_path, monkeypatch):
    gta = synthetic.make_gta5_fixture(str(tmp_path / "gta"), n=2, h=40, w=72)
    img, lbl = synthetic.make_cityscapes_fixture(str(tmp_path / "city"), n=2, h=40, w=72,
                                                 split="train")
    monkeypatch.setitem(presets.PRESETS, "tiny_warmup", _tiny())
    return ["--preset", "tiny_warmup", "--work_dir", str(tmp_path / "wd"),
            "--source_root", str(tmp_path / "gta"), "--source_list", gta,
            "--target_root", str(tmp_path / "city"), "--target_img_list", img,
            "--target_lbl_list", lbl]


def test_two_steps_log_and_export(argv, tmp_path, capsys):
    result = cli.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    # the trainer logs step 0 of every 50; the result holds the last step's
    losses = [float(v) for v in re.findall(r"\bloss=([-\d.eE+naif]+)", out)]
    assert len(losses) == 1 and all(math.isfinite(v) for v in losses), out
    assert set(result.last_metrics) == {"loss", "loss_semseg", "loss_distil"}
    assert all(math.isfinite(v) for v in result.last_metrics.values())
    with open(tmp_path / "wd" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [0]
    assert all(math.isfinite(r["loss_distil"]) and math.isfinite(r["loss_semseg"]) for r in recs)
    # no eval ran, so no best weights: only the last step's state (JAX writes no weights/ either)
    assert not os.path.exists(tmp_path / "wd" / "weights")
    assert not os.path.exists(tmp_path / "wd" / "ckpt_best")
    wdir = str(tmp_path / "wd" / "ckpt_final")
    assert sorted(os.listdir(wdir)) == ["dec_s2t.pth", "enc_s.pth", "state.pth", "student.pth",
                                        "teacher.pth"]
    assert torch.load(os.path.join(wdir, "state.pth"))["step"] == 2
    _, model = build_eval(_tiny(), wdir, torch.device("cpu"))  # strict load
    teacher = torch.load(os.path.join(wdir, "teacher.pth"))
    model.load_state_dict(teacher, strict=True)
    assert not any(k.endswith("num_batches_tracked") for k in teacher)


def test_defaults_to_the_card(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(argv)


@pytest.mark.parametrize("flags", [["--pretrained_backbone", "auto"],
                                   ["--n_devices", "0"], ["--multihost"],
                                   ["--preset", "gta2city_selftrain"]])
def test_unported_flags_are_refused(argv, flags, monkeypatch):
    """Refused: the download, a world of no rank, ``--multihost`` outside
    torchrun's environment, another stage's preset.  ``--n_devices 2``
    trains (tests/test_torch_port_parallel_cli.py)."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit):
        cli.main([*argv, "--device", "cpu", *flags])


def _with_eval(argv, tmp_path, monkeypatch, num_steps=2):
    """argv and the tiny preset with an eval after every step on one val image."""
    val_img, val_lbl = synthetic.make_cityscapes_fixture(str(tmp_path / "city"), n=1, h=40,
                                                         w=72, split="val")
    cfg = _tiny()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, eval_every=1,
                                                             num_steps=num_steps))
    monkeypatch.setitem(presets.PRESETS, "tiny_warmup", cfg)
    return cfg, [*argv, "--device", "cpu", "--val_img_list", val_img, "--val_lbl_list",
                 val_lbl, "--eval_limit", "1"]


def test_in_loop_eval_scores_and_exports_the_best(argv, tmp_path, monkeypatch):
    cfg, argv = _with_eval(argv, tmp_path, monkeypatch)
    result = cli.main(argv)
    with open(tmp_path / "wd" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    mious = [r["val/miou"] for r in recs if "val/miou" in r]
    assert len(mious) == 1 and 0.0 <= mious[0] <= 1.0  # step 1 (step 0 is never scored)
    assert result.best_step == (1 if mious[0] > 0 else 0)
    # step 1 is the last: a best there writes weights/ and ckpt_best/ beside ckpt_final
    assert os.path.exists(tmp_path / "wd" / "weights") == (mious[0] > 0)
    assert os.path.exists(tmp_path / "wd" / "ckpt_best") == (mious[0] > 0)
    for d in ("weights", "ckpt_best", "ckpt_final") if mious[0] > 0 else ("ckpt_final",):
        build_eval(cfg, str(tmp_path / "wd" / d), torch.device("cpu"))  # strict load


@pytest.mark.parametrize("mious,best", [((0.2, 0.5, 0.3), 2), ((0.0, 0.0, 0.0), None)],
                         ids=["best-before-last", "none-above-zero"])
def test_weights_hold_the_best_step_and_ckpt_final_the_last(argv, tmp_path, monkeypatch,
                                                            capsys, mious, best):
    """4 steps, scored after steps 1-3 with the mIoUs fixed by the test:
    ``weights`` and ``ckpt_best`` hold the best step's student and teacher
    (``ckpt_best`` with that step's counter, momentum and generators),
    ``ckpt_final`` the last step's, and a run with no mIoU above 0 writes
    neither ``weights`` nor ``ckpt_best``."""
    _, argv = _with_eval(argv, tmp_path, monkeypatch, num_steps=4)
    scores = iter(mious)

    class FixedScores(loop.TwoScaleEvaluator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            real = self.score.get_scores
            self.score.get_scores = lambda: ({**real()[0], "mean_iou": next(scores)},
                                             real()[1])

    monkeypatch.setattr(loop, "TwoScaleEvaluator", FixedScores)
    snapshots = []  # per step, the student's and teacher's weights after it
    build = train_seg.build_experiment

    def recording_build(*a, **kw):
        state, step, eval_apply = build(*a, **kw)

        def recording_step(state, batch):
            metrics = step(state, batch)
            snapshots.append({**{role: {k: v.clone() for k, v in
                                        reference_state_dict(getattr(state, role)).items()}
                                 for role in ("student", "teacher")},
                              "state": copy.deepcopy(state.state_dict()["state"])})
            return metrics

        return state, recording_step, eval_apply

    monkeypatch.setattr(train_seg, "build_experiment", recording_build)
    result = cli.main(argv)
    out = capsys.readouterr().out
    assert len(snapshots) == 4
    with open(tmp_path / "wd" / "metrics.jsonl") as f:
        assert [r["val/miou"] for r in map(json.loads, f) if "val/miou" in r] == list(mious)
    wd = tmp_path / "wd"

    def load(d, role):
        return torch.load(os.path.join(wd, d, f"{role}.pth"))

    def equal(a, b):
        return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

    def equal_state(d, snap):
        st = torch.load(os.path.join(wd, d, "state.pth"))
        mom = lambda o: [v["momentum_buffer"] for v in o["state"].values()]
        return (st["step"] == snap["step"] and st["generators"].keys() == snap["generators"].keys()
                and all(torch.equal(st["generators"][k], v) for k, v in snap["generators"].items())
                and all(torch.equal(a, b) for a, b in zip(mom(st["optimizer"]),
                                                          mom(snap["optimizer"]))))

    for role in ("student", "teacher"):
        assert equal(load("ckpt_final", role), snapshots[-1][role])
    assert equal_state("ckpt_final", snapshots[-1]["state"])
    if best is None:
        assert result.best_miou == 0.0 and not os.path.exists(wd / "weights")
        assert not os.path.exists(wd / "ckpt_best")
        assert "no best weights" in out and "ckpt_final" in out
        return
    assert result.best_step == best and result.best_miou == max(mious)
    for role in ("student", "teacher"):
        for d in ("weights", "ckpt_best"):
            assert equal(load(d, role), snapshots[best][role])
            assert not equal(load(d, role), snapshots[-1][role])
    assert equal_state("ckpt_best", snapshots[best]["state"])
    assert snapshots[best]["state"]["step"] == best + 1
    assert f"best weights in {wd}/weights and {wd}/ckpt_best" in out
