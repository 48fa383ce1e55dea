"""The port's warm-up trainer CLI on synthetic fixtures (CPU).

``diga_tpu_torch.cli.train_warm_up.main`` runs 2 steps of a tiny
registered preset (layers (1, 1, 1, 1), crop 32x64, f32) on synthetic
GTA5 and Cityscapes fixtures with ``--device cpu``: finite ``loss=`` lines,
a ``metrics.jsonl``, and ``student.pth``/``teacher.pth`` that load into the
port's eval model with ``strict=True``.  The weight directories are the JAX
trainer's (``diga_tpu/cli/train_seg.py:95-117``): ``<work_dir>/weights``
only on a new best mIoU, the last step's in ``<work_dir>/weights_final``
(the stand-in for JAX's ``ckpt_final``).  Without ``--device cpu`` it
raises here (the default is the card), and the flags whose slices have not
landed are refused.
"""

import dataclasses
import json
import math
import os
import re

import pytest
import torch

import diga_tpu_torch.cli.train_seg as train_seg
import diga_tpu_torch.cli.train_warm_up as cli
from diga_tpu_torch.configs import presets
from diga_tpu_torch.data import synthetic
from diga_tpu_torch.train import loop
from diga_tpu_torch.train.build import _reference_state_dict, build_eval

LAYERS = (1, 1, 1, 1)


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
    # no eval ran, so no best weights: only the last step's (JAX writes no weights/ either)
    assert not os.path.exists(tmp_path / "wd" / "weights")
    wdir = str(tmp_path / "wd" / "weights_final")
    assert sorted(os.listdir(wdir)) == ["student.pth", "teacher.pth"]
    _, model = build_eval(_tiny(), wdir, torch.device("cpu"))  # strict load
    teacher = torch.load(os.path.join(wdir, "teacher.pth"))
    model.load_state_dict(teacher, strict=True)
    assert not any(k.endswith("num_batches_tracked") for k in teacher)


def test_defaults_to_the_card(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(argv)


@pytest.mark.parametrize("flags", [["--resume"], ["--pretrained_backbone", "auto"],
                                   ["--n_devices", "2"], ["--multihost"],
                                   ["--preset", "gta2city_selftrain"]])
def test_unported_flags_are_refused(argv, flags):
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
    # step 1 is the last: a best there writes weights/ beside weights_final
    assert os.path.exists(tmp_path / "wd" / "weights") == (mious[0] > 0)
    for d in ("weights", "weights_final") if mious[0] > 0 else ("weights_final",):
        build_eval(cfg, str(tmp_path / "wd" / d), torch.device("cpu"))  # strict load


@pytest.mark.parametrize("mious,best", [((0.2, 0.5, 0.3), 2), ((0.0, 0.0, 0.0), None)],
                         ids=["best-before-last", "none-above-zero"])
def test_weights_hold_the_best_step_and_weights_final_the_last(argv, tmp_path, monkeypatch,
                                                               capsys, mious, best):
    """4 steps, scored after steps 1-3 with the mIoUs fixed by the test:
    ``weights`` holds the best step's student and teacher, ``weights_final``
    the last step's, and a run with no mIoU above 0 writes no ``weights``."""
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
            snapshots.append({role: {k: v.clone() for k, v in
                                     _reference_state_dict(getattr(state, role)).items()}
                              for role in ("student", "teacher")})
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

    for role in ("student", "teacher"):
        assert equal(load("weights_final", role), snapshots[-1][role])
    if best is None:
        assert result.best_miou == 0.0 and not os.path.exists(wd / "weights")
        assert "no best weights" in out and "weights_final" in out
        return
    assert result.best_step == best and result.best_miou == max(mious)
    for role in ("student", "teacher"):
        assert equal(load("weights", role), snapshots[best][role])
        assert not equal(load("weights", role), snapshots[-1][role])
    assert f"best weights in {wd}/weights" in out
