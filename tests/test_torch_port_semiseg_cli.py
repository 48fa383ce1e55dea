"""The port's semi-supervised Cityscapes chain through its CLIs (CPU).

A tiny HRNet+OCR (registered as ``hrnet_arch=tiny``; 32-d features) in tiny
copies of the ``semiseg_1_8_*`` presets (crop 32x64, f32, streams of one
image), on a synthetic Cityscapes fixture split into a labeled half (the
source stream: ``--source_list`` and, paired by position,
``--target_lbl_list``) and an unlabeled half (``--target_img_list``), all
with ``--device cpu``:

  train_warm_up -> pseudolabel_generator -> calc_centroids ->
  train_self_training -> evaluate_val

* ``--pretrained_backbone`` lays a seeded ImageNet-layout hrnetv2 file over
  the backbone (the OCR head keeps its init);
* the warm-up and self-training log finite losses (self-training with
  ``loss_crossmix`` and ``consensus_kept`` in [0, 1]) and write
  ``ckpt_final`` without translator roles; its ``student.pth`` loads
  strictly into the eval model;
* ``calc_centroids`` writes (19, 32) centroids equal to the masked means of
  the eval model on the BGR image, as the JAX CLI feeds it (ROADMAP D3);
  ``--source`` is refused, as the JAX CLI cannot run it (D4);
* ``evaluate_val`` scores and dumps the argmax of the two-scale logits of
  the RGB-flipped input;
* a save after one step restores into a fresh state that continues bit for
  bit (the tiny semiseg warm-up, dropout on);
* the JAX HRNet's TPU knobs are refused by name;
* ``train_self_training --extra fuse_forwards=true`` runs 2 steps with the
  same checks.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

import diga_tpu_torch.cli.calc_centroids as calc_centroids
import diga_tpu_torch.cli.evaluate_val as evaluate_val
import diga_tpu_torch.cli.pseudolabel_generator as pseudolabel_generator
import diga_tpu_torch.cli.train_self_training as train_self_training
import diga_tpu_torch.cli.train_warm_up as train_warm_up
from diga_tpu_torch.configs import presets
from diga_tpu_torch.data import cityscapes_dataset, synthetic
from diga_tpu_torch.eval.evaluator import two_scale_logits
from diga_tpu_torch.models import hrnet_ocr
from diga_tpu_torch.ops.prototypes import Centroids, masked_class_means, update_centroids
from diga_tpu_torch.train.build import build_eval, build_experiment
from diga_tpu_torch.utils.checkpoint import restore_train_state, save_train_state

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
HW = (40, 72)
OUT_HW, DS_HW = (40, 72), (20, 36)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on one host, and
    the tiny HRNet's thousand small ops a step only contend across more."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tiny(name, **train):
    base = presets.get_preset(name)

    def streams(specs):
        return tuple(dataclasses.replace(s, resize_hw=hw, batch=1)
                     for s, hw in zip(specs, ((40, 72), (48, 80))))

    return dataclasses.replace(
        base,
        data=dataclasses.replace(base.data, num_workers=1,
                                 source_streams=streams(base.data.source_streams),
                                 target_streams=streams(base.data.target_streams)),
        train=dataclasses.replace(base.train, crop_hw=(32, 64), compute_dtype="float32",
                                  num_steps=2, eval_every=0, **train),
        eval=presets.EvalConfig(out_hw=OUT_HW, ds_hw=DS_HW),
        extra={**base.extra, "hrnet_arch": "tiny", "feat_dim": TINY["ocr_mid_channels"]})


def _write_list(path, names) -> str:
    with open(path, "w") as f:
        f.write("\n".join(names) + "\n")
    return str(path)


def _imagenet_file(path, seed=7) -> dict:
    """A seeded hrnetv2 ImageNet-layout file: the backbone's tensors in
    order under the classification net's names, BN counters, a trailing
    classifier."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in hrnet_ocr.HRNetOCR(K, TINY).state_dict().items():
        if not k.startswith("hrnet."):
            continue
        k = k[len("hrnet."):].replace("stage1.", "layer1.", 1)
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(3)
            continue
        a = rng.normal(size=tuple(v.shape)) * (0.3 if v.ndim > 1 else 0.1)
        sd[k] = torch.from_numpy(np.abs(a) + 0.5 if k.endswith("running_var") else
                                 a + 1.0 if k.endswith("weight") and v.ndim == 1 else a).float()
    sd["classifier.weight"] = torch.zeros(1000, 2048)
    torch.save(sd, path)
    return sd


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The fixture split, a seeded hrnetv2 file, and the tiny arch and
    presets registered (restored afterwards)."""
    tmp = tmp_path_factory.mktemp("semiseg")
    city = str(tmp / "city")
    img, lbl = synthetic.make_cityscapes_fixture(city, n=4, h=HW[0], w=HW[1], split="train")
    val_img, val_lbl = synthetic.make_cityscapes_fixture(str(tmp / "val"), n=1, h=HW[0], w=HW[1],
                                                         split="val")
    with open(img) as f:
        imgs = f.read().split()
    with open(lbl) as f:
        lbls = f.read().split()
    data = ["--source_root", city, "--target_root", city,
            "--source_list", _write_list(tmp / "labeled.txt", imgs[:2]),
            "--target_lbl_list", _write_list(tmp / "labeled_lbl.txt", lbls[:2]),
            "--target_img_list", _write_list(tmp / "unlabeled.txt", imgs[2:])]
    backbone = str(tmp / "hrnetv2_seeded.pth")
    _imagenet_file(backbone)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(hrnet_ocr.ARCHS, "tiny", TINY)
        mp.setitem(presets.PRESETS, "tiny_semiseg_warmup", _tiny("semiseg_1_8_warmup"))
        mp.setitem(presets.PRESETS, "tiny_semiseg_selftrain", _tiny("semiseg_1_8_selftrain"))
        yield {"tmp": tmp, "city": city, "data": data, "backbone": backbone,
               "val": ["--val_img_list", val_img, "--val_lbl_list", val_lbl],
               "val_root": str(tmp / "val"), "unlabeled": str(tmp / "unlabeled.txt"),
               "labeled_lbl": str(tmp / "labeled_lbl.txt")}


def _losses(out: str) -> list[dict]:
    return [dict((k, float(v)) for k, v in re.findall(r"(\w+)=([-\d.eE+naif]+)", line))
            for line in out.splitlines() if line.startswith("step ") and "loss=" in line]


def _check_run(wd, result, logged, metrics):
    assert len(logged) == 1 and metrics <= set(logged[0])
    assert set(result.last_metrics) == metrics
    for m in (logged[0], result.last_metrics):
        assert all(math.isfinite(m[k]) for k in metrics)
        assert 0.0 <= m.get("consensus_kept", 0.0) <= 1.0
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [0]
    final = os.path.join(wd, "ckpt_final")
    assert not os.path.exists(os.path.join(wd, "weights"))  # no eval, so no best weights
    assert sorted(os.listdir(final)) == ["state.pth", "student.pth", "teacher.pth"]
    assert torch.load(os.path.join(final, "state.pth"))["step"] == 2
    return final


def _train(cli, argv, wd, metrics) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = cli.main(["--work_dir", wd, "--device", "cpu", *argv])
    return _check_run(wd, result, _losses(out.getvalue()), metrics)


@pytest.fixture(scope="module")
def warm(chain):
    """train_warm_up, 2 steps from the seeded ImageNet backbone; its ckpt_final."""
    return _train(train_warm_up, ["--preset", "tiny_semiseg_warmup", "--pretrained_backbone",
                                  chain["backbone"], *chain["data"]],
                  str(chain["tmp"] / "warmup"), {"loss", "loss_semseg", "loss_distil"})


@pytest.fixture(scope="module")
def pseudo_labels(chain, warm):
    pseudo = os.path.join(chain["city"], "pseudo_train_warm_up")
    n = pseudolabel_generator.main(["--preset", "tiny_semiseg_warmup", "--weight_dir", warm,
                                    "--output_dir", pseudo, "--device", "cpu", *chain["data"]])
    assert n == 2
    return pseudo


@pytest.fixture(scope="module")
def selftrained(chain, warm, pseudo_labels):
    """calc_centroids on the target, then train_self_training, 2 steps, on the
    pseudo-labels; its ckpt_final."""
    cdir = str(chain["tmp"] / "centroids")
    calc_centroids.main(["--preset", "tiny_semiseg_warmup", "--weight_dir", warm,
                         "--centroid_dir", cdir, "--epochs", "1", "--device", "cpu",
                         *chain["data"]])
    return _train(train_self_training,
                  ["--preset", "tiny_semiseg_selftrain", "--load_weight_dir", warm,
                   "--centroid_path", os.path.join(cdir, "feat_centroids.npy"), *chain["data"]],
                  str(chain["tmp"] / "selftrain"),
                  {"loss", "loss_semseg", "loss_crossmix", "loss_distil", "consensus_kept"})


def test_pretrained_backbone_lays_the_imagenet_file_over_hrnet(chain):
    cfg = presets.get_preset("tiny_semiseg_warmup")
    fresh, _, _ = build_experiment(cfg, CPU)
    state, _, _ = build_experiment(cfg, CPU, pretrained_backbone=chain["backbone"])
    sd = torch.load(chain["backbone"])
    ours = state.student.state_dict()
    pairs = zip([k for k in ours if k.startswith("hrnet.") and "num_batches" not in k],
                [k for k in sd if "num_batches" not in k])
    for k, f in pairs:
        assert torch.equal(ours[k], sd[f]), (k, f)
    for k, v in fresh.student.state_dict().items():
        if k.startswith("ocrnet."):
            assert torch.equal(ours[k], v), k
    for k, v in state.teacher.state_dict().items():
        assert torch.equal(ours[k], v), k


def test_warm_up_writes_a_strictly_loading_student(chain, warm):
    _, model = build_eval(presets.get_preset("tiny_semiseg_warmup"), warm, CPU)  # strict
    assert isinstance(model, hrnet_ocr.HRNetOCR)
    model.load_state_dict(torch.load(os.path.join(warm, "teacher.pth")), strict=True)


def test_pseudo_labels_are_the_two_scale_argmax(chain, warm, pseudo_labels):
    assert len(os.listdir(pseudo_labels)) == 2
    eval_apply, _ = build_eval(presets.get_preset("tiny_semiseg_warmup"), warm, CPU)
    ds = cityscapes_dataset(chain["city"], chain["unlabeled"], chain["labeled_lbl"],
                            split="train", resize_hw=OUT_HW)
    for i in range(2):
        png = Image.open(os.path.join(pseudo_labels, os.path.basename(ds[i]["name"])))
        with torch.inference_mode():
            merged = two_scale_logits(eval_apply, torch.from_numpy(ds[i]["image"][None]),
                                      OUT_HW, DS_HW)[0]
        assert png.mode == "P"
        np.testing.assert_array_equal(np.array(png), merged.argmax(-1).numpy())


def test_self_training_writes_a_strictly_loading_student(selftrained):
    _, model = build_eval(presets.get_preset("tiny_semiseg_selftrain"), selftrained, CPU)
    model.load_state_dict(torch.load(os.path.join(selftrained, "teacher.pth")), strict=True)


def test_calc_centroids_feeds_the_model_bgr(chain, warm):
    cdir = str(chain["tmp"] / "cent_bgr")
    cents = calc_centroids.main(["--preset", "tiny_semiseg_warmup", "--weight_dir", warm,
                                 "--centroid_dir", cdir, "--epochs", "1", "--device", "cpu",
                                 *chain["data"]])
    vec = np.load(os.path.join(cdir, "feat_centroids.npy"))
    assert vec.shape == (K, TINY["ocr_mid_channels"]) and np.isfinite(vec).all()
    assert float(cents.counts.sum()) > 0
    _, model = build_eval(presets.get_preset("tiny_semiseg_warmup"), warm, CPU)
    ds = cityscapes_dataset(chain["city"], chain["unlabeled"], chain["labeled_lbl"],
                            split="train", resize_hw=(40, 72))
    want = Centroids.create(K, TINY["ocr_mid_channels"])
    for i in range(len(ds)):
        with torch.inference_mode():  # no RGB flip, as the JAX CLI (:42-46)
            _, _, logits, feat = model(torch.from_numpy(ds[i]["image"][None]).permute(0, 3, 1, 2))
            v, ok = masked_class_means(feat.permute(0, 2, 3, 1), logits.permute(0, 2, 3, 1), None)
            want = update_centroids(want, v, ok, start_mean=True)
    np.testing.assert_allclose(vec, want.vectors.numpy(), rtol=1e-5, atol=1e-6)


def test_calc_centroids_source_is_refused_with_the_reason(chain, capsys):
    with pytest.raises(SystemExit):
        calc_centroids.main(["--preset", "tiny_semiseg_warmup", "--centroid_dir",
                             str(chain["tmp"] / "x"), "--source", "--device", "cpu",
                             *chain["data"]])
    err = capsys.readouterr().err
    assert "--source on a 'cityscapes' source" in err and "no image translator" in err


def test_evaluate_val_scores_the_rgb_flipped_input(chain, selftrained):
    final = selftrained
    dump = str(chain["tmp"] / "preds")
    results = evaluate_val.main(["--preset", "tiny_semiseg_selftrain", "--weight_dir", final,
                                 "--target_root", chain["val_root"], *chain["val"],
                                 "--eval_limit", "1", "--dump_preds", dump, "--device", "cpu"])
    scores = results["cityscapes"]
    assert 0.0 <= scores["mean_iou"] <= 1.0
    cfg = presets.get_preset("tiny_semiseg_selftrain")
    eval_apply, model = build_eval(cfg, final, CPU)
    ds = cityscapes_dataset(chain["val_root"], chain["val"][1], chain["val"][3],
                            resize_hw=OUT_HW)
    image = torch.from_numpy(ds[0]["image"][None])
    with torch.inference_mode():
        merged = two_scale_logits(eval_apply, image, OUT_HW, DS_HW)[0]
        flipped = model(torch.flip(image, dims=(-1,)).permute(0, 3, 1, 2))[2]
        assert torch.equal(eval_apply(image), flipped.permute(0, 2, 3, 1))
    assert torch.isfinite(merged).all()
    base = os.path.splitext(os.path.basename(ds[0]["name"]))[0]
    np.testing.assert_array_equal(np.array(Image.open(os.path.join(dump, base + ".png"))),
                                  merged.argmax(-1).numpy())


def _batch(i, stage):
    rr = np.random.default_rng(70 + i)
    lbl = rr.choice(rr.choice(K, size=6, replace=False), size=(2, 32, 64)).astype(np.int32)
    lbl[:, :3] = 255
    b = {"s_img": (rr.normal(size=(2, 32, 64, 3)) * 0.5).astype(np.float32), "s_lbl": lbl,
         "t_img": (rr.normal(size=(2, 32, 64, 3)) * 0.5).astype(np.float32)}
    if stage == "selftrain":
        b["t_pseudo"] = rr.choice(rr.choice(K, size=4, replace=False),
                                  size=(2, 32, 64)).astype(np.int32)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _snapshot(state) -> dict:
    st = state.state_dict()
    out = {f"{r}|{k}": v.clone() for r in ("student", "teacher")
           for k, v in st["roles"][r].items()}
    out.update({f"gen|{k}": v for k, v in st["state"]["generators"].items()})
    out.update({f"momentum|{i}": v["momentum_buffer"].clone()
                for i, v in st["state"]["optimizer"]["state"].items()})
    out["step"] = torch.tensor(state.step)
    return out


def test_save_restore_continues_bit_for_bit(chain, tmp_path):
    cfg = presets.get_preset("tiny_semiseg_warmup")
    state, step, _ = build_experiment(cfg, CPU)
    assert state.student.channel_dropout.p == 0.05  # dropout draws on
    straight = []
    for i in range(3):
        if i == 1:
            save_train_state(str(tmp_path / "ckpt"), state)
            at_save = _snapshot(state)
        straight.append({k: float(v) for k, v in step(state, _batch(i, "warmup")).items()})
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["state.pth", "student.pth", "teacher.pth"]
    fresh, fresh_step, _ = build_experiment(cfg, CPU)
    restore_train_state(str(tmp_path / "ckpt"), fresh)
    restored = _snapshot(fresh)
    assert restored.keys() == at_save.keys()
    assert all(torch.equal(restored[k], v) for k, v in at_save.items()), "restore != save"
    assert fresh.student.channel_dropout.generator is fresh.gen_student_dropout
    assert fresh.teacher.channel_dropout.generator is fresh.gen_teacher_dropout
    resumed = [{k: float(v) for k, v in fresh_step(fresh, _batch(i, "warmup")).items()}
               for i in (1, 2)]
    assert resumed == straight[1:]
    a, b = _snapshot(state), _snapshot(fresh)
    assert all(torch.equal(a[k], b[k]) for k in a), [k for k in a if not torch.equal(a[k], b[k])]


@pytest.mark.parametrize("extra", ["hrnet_pad=64", "remat_policy=bn_stats", "remat=true"])
def test_tpu_knobs_and_fuse_forwards_are_refused(chain, extra, capsys):
    with pytest.raises(SystemExit):
        train_self_training.main(["--preset", "tiny_semiseg_selftrain", "--work_dir",
                                  str(chain["tmp"] / "x"), "--device", "cpu",
                                  "--extra", extra, *chain["data"]])
    assert f"--extra {extra.split('=')[0]}" in capsys.readouterr().err


def test_self_training_fused_two_steps(chain, warm, pseudo_labels):
    _train(train_self_training,
           ["--preset", "tiny_semiseg_selftrain", "--load_weight_dir", warm,
            "--extra", "fuse_forwards=true", *chain["data"]],
           str(chain["tmp"] / "selftrain_fused"),
           {"loss", "loss_semseg", "loss_crossmix", "loss_distil", "consensus_kept"})
