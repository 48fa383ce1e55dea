"""The port's stage chain CLIs on synthetic fixtures (CPU), against the JAX CLIs.

Tiny presets (layers (1, 1, 1, 1), f32, crop 32x64, eval 40x72 + 20x36)
are registered in both packages' preset registries; the port runs with
``--device cpu`` (its plain PyTorch path) and JAX on the CPU.

* ``pseudolabel_generator``: the port's and the JAX CLI's PNGs from the same
  ``student.pth`` have the same names and palette, and their label maps
  agree wherever the top two merged logits differ by more than 1e-4;
* ``calc_centroids``: the target branch, 2 epochs, within 1e-5 of the JAX
  CLI's ``feat_centroids.npy``; ``--source`` writes finite (K, 256)
  centroids (its accumulation is held against JAX in
  tests/test_torch_port_prototypes.py);
* ``train_self_training``, 2 steps on pseudo-labels that the port's own
  generator wrote and centroids its own ``calc_centroids`` wrote: finite
  losses with ``loss_crossmix``, ``consensus_kept`` in [0, 1], and the
  full state in ``ckpt_final`` (no eval, so no ``weights``) whose
  ``student.pth``/``teacher.pth`` load strictly;
* ``train_dg``, 2 steps, likewise;
* ``train_self_training --extra fuse_forwards=true``, 2 steps: the same
  checks (its step is held against JAX's fused step in
  tests/test_torch_port_fuse_forwards.py);
* without ``--device cpu`` each raises here, and ``--pretrained_backbone
  auto`` and the translator preset are refused.
"""

import dataclasses
import json
import math
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

import diga_tpu.cli.calc_centroids as jax_calc_centroids
import diga_tpu.cli.pseudolabel_generator as jax_pseudolabel
from diga_tpu.configs import presets as jax_presets
from diga_tpu.models.convert import segmodel_to_torch
from diga_tpu.utils.checkpoint import export_role_keyed
import diga_tpu_torch.cli.calc_centroids as calc_centroids
import diga_tpu_torch.cli.pseudolabel_generator as pseudolabel_generator
import diga_tpu_torch.cli.train_dg as train_dg
import diga_tpu_torch.cli.train_self_training as train_self_training
from diga_tpu_torch.configs import presets as port_presets
from diga_tpu_torch.data import cityscapes_dataset, synthetic
from diga_tpu_torch.data.label_maps import CITYSCAPES_COLORS_19, make_png_palette
from diga_tpu_torch.eval.evaluator import two_scale_logits
from diga_tpu_torch.train.build import build_eval

from _torch_port_common import LAYERS, jax_tiny_deeplab

K = 19
HW = (40, 72)
OUT_HW, DS_HW = (40, 72), (20, 36)


def _tiny(presets, name):
    base = presets.get_preset(name)

    def streams(specs, hws):
        return tuple(dataclasses.replace(s, resize_hw=hw, batch=1) for s, hw in zip(specs, hws))

    return dataclasses.replace(
        base,
        data=dataclasses.replace(
            base.data, num_workers=1,
            source_streams=streams(base.data.source_streams, ((40, 72), (48, 80))),
            target_streams=streams(base.data.target_streams, ((40, 72), (48, 80)))),
        train=dataclasses.replace(base.train, crop_hw=(32, 64), compute_dtype="float32",
                                  remat=False, num_steps=2, eval_every=0),
        eval=presets.EvalConfig(out_hw=OUT_HW, ds_hw=DS_HW),
        extra={"layers": LAYERS})


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """Fixtures, a student.pth from a JAX init where a warm-up's
    ``ckpt_final`` holds it (a warm-up with no eval writes no ``weights``),
    and the tiny presets in both registries (restored afterwards)."""
    tmp = tmp_path_factory.mktemp("chain")
    gta_list = synthetic.make_gta5_fixture(str(tmp / "gta"), n=2, h=HW[0], w=HW[1])
    img, lbl = synthetic.make_cityscapes_fixture(str(tmp / "city"), n=2, h=HW[0], w=HW[1],
                                                 split="train")
    _, params, stats = jax_tiny_deeplab(seed=31, hw=HW)
    wdir = str(tmp / "warmup" / "ckpt_final")
    export_role_keyed(wdir, {"student": segmodel_to_torch(params, stats, LAYERS)})
    names = {"gta2city_warmup": "tiny_chain_warmup", "gta2city_selftrain": "tiny_chain_st",
             "dg_gta5": "tiny_chain_dg"}
    with pytest.MonkeyPatch.context() as mp:
        for base, tiny in names.items():
            mp.setitem(jax_presets.PRESETS, tiny, _tiny(jax_presets, base))
            mp.setitem(port_presets.PRESETS, tiny, _tiny(port_presets, base))
        data = ["--source_root", str(tmp / "gta"), "--source_list", gta_list,
                "--target_root", str(tmp / "city"), "--target_img_list", img,
                "--target_lbl_list", lbl]
        yield {"tmp": tmp, "wdir": wdir, "data": data, "city": str(tmp / "city"),
               "img_list": img, "lbl_list": lbl}


def _pseudo(chain, out, cli, *extra):
    return cli.main(["--preset", "tiny_chain_warmup", "--weight_dir", chain["wdir"],
                     "--output_dir", out, *chain["data"], *extra])


def test_pseudolabel_generator_matches_jax_cli(chain):
    out_port, out_jax = str(chain["tmp"] / "pl_port"), str(chain["tmp"] / "pl_jax")
    assert _pseudo(chain, out_port, pseudolabel_generator, "--device", "cpu") == 2
    _pseudo(chain, out_jax, jax_pseudolabel)
    names = sorted(os.listdir(out_jax))
    assert sorted(os.listdir(out_port)) == names and len(names) == 2
    cfg = port_presets.get_preset("tiny_chain_warmup")
    eval_apply, _ = build_eval(cfg, chain["wdir"], torch.device("cpu"))
    ds = cityscapes_dataset(chain["city"], chain["img_list"], chain["lbl_list"], split="train",
                            resize_hw=OUT_HW)
    for i, name in enumerate(names):
        assert name == os.path.basename(ds[i]["name"])
        a, b = Image.open(os.path.join(out_port, name)), Image.open(os.path.join(out_jax, name))
        assert a.mode == b.mode == "P"
        assert a.getpalette() == b.getpalette() == make_png_palette(CITYSCAPES_COLORS_19)
        with torch.inference_mode():
            merged = two_scale_logits(eval_apply, torch.from_numpy(ds[i]["image"][None]),
                                      OUT_HW, DS_HW)[0]
        top2 = torch.topk(merged, 2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1] > 1e-4).numpy()
        a, b = np.array(a), np.array(b)
        assert a.shape == b.shape == OUT_HW and clear.mean() > 0.9
        np.testing.assert_array_equal(a[clear], b[clear])
        np.testing.assert_array_equal(a, merged.argmax(-1).numpy())


def _centroids(chain, out, cli, *extra):
    return cli.main(["--preset", "tiny_chain_warmup", "--weight_dir", chain["wdir"],
                     "--centroid_dir", out, "--epochs", "2", *chain["data"], *extra])


def test_calc_centroids_matches_jax_cli(chain):
    out_port, out_jax = str(chain["tmp"] / "cent_port"), str(chain["tmp"] / "cent_jax")
    _centroids(chain, out_port, calc_centroids, "--device", "cpu")
    _centroids(chain, out_jax, jax_calc_centroids)
    ours = np.load(os.path.join(out_port, "feat_centroids.npy"))
    ref = np.load(os.path.join(out_jax, "feat_centroids.npy"))
    assert ours.shape == ref.shape == (K, 256) and np.abs(ref).sum(axis=1).astype(bool).any()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    torch_file = torch.load(os.path.join(out_port, "feat_centroids"))
    np.testing.assert_array_equal(torch_file.numpy(), ours)


def test_calc_centroids_source_branch_writes_finite_centroids(chain):
    out = str(chain["tmp"] / "cent_src")
    cents = _centroids(chain, out, calc_centroids, "--device", "cpu", "--source")
    vec = np.load(os.path.join(out, "feat_centroids.npy"))
    assert vec.shape == (K, 256) and np.isfinite(vec).all()
    assert float(cents.counts.sum()) > 0 and np.abs(vec).sum() > 0


def _losses(out: str) -> list[dict]:
    return [dict((k, float(v)) for k, v in re.findall(r"(\w+)=([-\d.eE+naif]+)", line))
            for line in out.splitlines() if line.startswith("step ") and "loss=" in line]


def test_train_self_training_on_the_ports_own_pseudo_labels_and_centroids(chain, capsys):
    _pseudo(chain, os.path.join(chain["city"], "pseudo_train_warm_up"), pseudolabel_generator,
            "--device", "cpu")
    cdir = str(chain["tmp"] / "cent_chain")
    calc_centroids.main(["--preset", "tiny_chain_warmup", "--weight_dir", chain["wdir"],
                         "--centroid_dir", cdir, "--epochs", "1", "--device", "cpu",
                         *chain["data"]])
    capsys.readouterr()
    wd = str(chain["tmp"] / "st")
    result = train_self_training.main(
        ["--preset", "tiny_chain_st", "--work_dir", wd, "--load_weight_dir", chain["wdir"],
         "--centroid_path", os.path.join(cdir, "feat_centroids.npy"), "--device", "cpu",
         *chain["data"]])
    logged = _losses(capsys.readouterr().out)
    metrics = {"loss", "loss_semseg", "loss_crossmix", "loss_distil", "consensus_kept"}
    assert len(logged) == 1 and metrics <= set(logged[0])
    assert set(result.last_metrics) == metrics
    for m in (logged[0], result.last_metrics):
        assert all(math.isfinite(m[k]) for k in metrics)
        assert 0.0 <= m["consensus_kept"] <= 1.0
    with open(os.path.join(wd, "metrics.jsonl")) as f:
        assert [json.loads(line)["step"] for line in f] == [0]
    cfg = port_presets.get_preset("tiny_chain_st")
    assert not os.path.exists(os.path.join(wd, "weights"))  # no eval, so no best weights
    final = os.path.join(wd, "ckpt_final")
    assert sorted(os.listdir(final)) == ["dec_s2t.pth", "enc_s.pth", "state.pth", "student.pth",
                                         "teacher.pth"]
    _, model = build_eval(cfg, final, torch.device("cpu"))  # strict
    model.load_state_dict(torch.load(os.path.join(final, "teacher.pth")), strict=True)


def test_train_self_training_fused_two_steps(chain, capsys):
    pseudo = os.path.join(chain["city"], "pseudo_train_warm_up")
    if not os.path.isdir(pseudo):
        _pseudo(chain, pseudo, pseudolabel_generator, "--device", "cpu")
    capsys.readouterr()
    wd = str(chain["tmp"] / "st_fused")
    result = train_self_training.main(
        ["--preset", "tiny_chain_st", "--work_dir", wd, "--load_weight_dir", chain["wdir"],
         "--extra", "fuse_forwards=true", "--device", "cpu", *chain["data"]])
    logged = _losses(capsys.readouterr().out)
    metrics = {"loss", "loss_semseg", "loss_crossmix", "loss_distil", "consensus_kept"}
    assert len(logged) == 1 and metrics <= set(logged[0])
    assert set(result.last_metrics) == metrics
    for m in (logged[0], result.last_metrics):
        assert all(math.isfinite(m[k]) for k in metrics)
        assert 0.0 <= m["consensus_kept"] <= 1.0
    assert not os.path.exists(os.path.join(wd, "weights"))  # no eval, so no best weights
    assert torch.load(os.path.join(wd, "ckpt_final", "state.pth"))["step"] == 2


def test_train_dg_two_steps(chain, capsys):
    wd = str(chain["tmp"] / "dg")
    result = train_dg.main(["--preset", "tiny_chain_dg", "--work_dir", wd, "--device", "cpu",
                            *chain["data"]])
    logged = _losses(capsys.readouterr().out)
    assert len(logged) == 1 and all(math.isfinite(v) for v in logged[0].values())
    assert set(result.last_metrics) == {"loss", "loss_semseg", "loss_distil"}
    assert all(math.isfinite(v) for v in result.last_metrics.values())
    assert not os.path.exists(os.path.join(wd, "weights"))  # no eval, so no best weights
    assert sorted(os.listdir(os.path.join(wd, "ckpt_final"))) == ["state.pth", "student.pth",
                                                                  "teacher.pth"]


def _argv(chain, cli):
    if cli is pseudolabel_generator:
        return ["--preset", "tiny_chain_warmup", "--output_dir", str(chain["tmp"] / "x"),
                *chain["data"]]
    if cli is calc_centroids:
        return ["--preset", "tiny_chain_warmup", "--centroid_dir", str(chain["tmp"] / "x"),
                *chain["data"]]
    preset = "tiny_chain_dg" if cli is train_dg else "tiny_chain_st"
    return ["--preset", preset, "--work_dir", str(chain["tmp"] / "x"), *chain["data"]]


@pytest.mark.parametrize("cli", [pseudolabel_generator, calc_centroids, train_self_training,
                                 train_dg], ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_new_clis_default_to_the_card(chain, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(_argv(chain, cli))


@pytest.mark.parametrize("flags", [["--pretrained_backbone", "auto"],
                                   ["--preset", "gta2city_translator"]])
def test_self_training_refusals(chain, flags, capsys):
    with pytest.raises(SystemExit):
        train_self_training.main([*_argv(chain, train_self_training), "--device", "cpu", *flags])
    err = capsys.readouterr().err
    assert ("ROADMAP queue A item" in err or "expected 'selftrain'" in err
            or "auto downloads" in err)
