"""The port's warm-up trainer CLI on synthetic fixtures (CPU).

``diga_tpu_torch.cli.train_warm_up.main`` runs 2 steps of a tiny
registered preset (layers (1, 1, 1, 1), crop 32x64, f32) on synthetic
GTA5 and Cityscapes fixtures with ``--device cpu``: finite ``loss=`` lines,
a ``metrics.jsonl``, and ``student.pth``/``teacher.pth`` that load into the
port's eval model with ``strict=True``.  Without ``--device cpu`` it
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

import diga_tpu_torch.cli.train_warm_up as cli
from diga_tpu_torch.configs import presets
from diga_tpu_torch.data import synthetic
from diga_tpu_torch.train.build import build_eval

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
    wdir = str(tmp_path / "wd" / "weights")
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


def test_in_loop_eval_scores_and_exports_the_best(argv, tmp_path, monkeypatch):
    val_img, val_lbl = synthetic.make_cityscapes_fixture(str(tmp_path / "city"), n=1, h=40,
                                                         w=72, split="val")
    cfg = _tiny()
    monkeypatch.setitem(presets.PRESETS, "tiny_warmup",
                        dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                           eval_every=1)))
    result = cli.main([*argv, "--device", "cpu", "--val_img_list", val_img,
                       "--val_lbl_list", val_lbl, "--eval_limit", "1"])
    with open(tmp_path / "wd" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    mious = [r["val/miou"] for r in recs if "val/miou" in r]
    assert len(mious) == 1 and 0.0 <= mious[0] <= 1.0  # step 1 (step 0 is never scored)
    assert result.best_step == (1 if mious[0] > 0 else 0)
    if mious[0] > 0:  # the best weights load strictly into the eval model
        build_eval(cfg, str(tmp_path / "wd" / "weights_best"), torch.device("cpu"))
