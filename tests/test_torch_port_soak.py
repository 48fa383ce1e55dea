"""``cli/soak.py`` and its fixtures against ``diga_tpu`` (CPU).

* ``make_pseudo_fixture``, ``make_bdd_reference_fixture`` and
  ``make_mapillary_reference_fixture`` write JAX's files from the same
  seed: the same names and lists, decoded pixels equal (JPEGs included);
* ``_loss_windows`` and ``_series`` give JAX's values on the same
  ``metrics.jsonl``, and ``_head_tail`` the translator soaks' windows;
* the onchip soak's banded labels and pseudo-labels are JAX's rule
  (``soak.py:343-355``) on the same array, exactly;
* ``soak --tiny --device cpu`` runs in-process and passes its own
  invariants: the translator (quick), the onchip mode on tiny presets
  (quick), and the fixture soak for ``dg_gta5`` and
  ``gta2city_selftrain`` (``slow``: R101's widths at one block a stage
  take about 1 s a step on one CPU thread, and the invariants need 80 and
  more steps).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from diga_tpu.cli import soak as jax_soak
from diga_tpu.data import synthetic as jax_synthetic
from diga_tpu_torch.cli import soak
from diga_tpu_torch.configs import presets
from diga_tpu_torch.data import synthetic


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers on one host."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _same_tree(a, b):
    files = _tree(a)
    assert files == _tree(b) and files
    for f in files:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith(".txt"):
            assert open(pa).read() == open(pb).read(), f
        else:
            ia, ib = Image.open(pa), Image.open(pb)
            assert ia.mode == ib.mode, f
            np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib), err_msg=f)
            if ia.mode == "P":
                assert ia.getpalette() == ib.getpalette(), f


@pytest.mark.parametrize("fixture,kw", [("make_bdd_reference_fixture", {}),
                                        ("make_bdd_reference_fixture", dict(n=3, h=20, w=36,
                                                                            seed=9)),
                                        ("make_mapillary_reference_fixture", {}),
                                        ("make_mapillary_reference_fixture", dict(n=3, seed=2))])
def test_reference_fixtures_equal_jax(tmp_path, fixture, kw):
    got = getattr(synthetic, fixture)(str(tmp_path / "port"), **kw)
    want = getattr(jax_synthetic, fixture)(str(tmp_path / "jax"), **kw)
    assert [os.path.relpath(p, tmp_path / "port") for p in got] == \
        [os.path.relpath(p, tmp_path / "jax") for p in want]
    _same_tree(tmp_path / "port", tmp_path / "jax")


def test_pseudo_fixture_equals_jax(tmp_path):
    for side in ("port", "jax"):
        mod = synthetic if side == "port" else jax_synthetic
        img_list, _ = mod.make_cityscapes_fixture(str(tmp_path / side), n=3, h=24, w=40,
                                                  split="train")
        assert mod.make_pseudo_fixture(str(tmp_path / side), img_list, 24, 40) == "pseudo"
    _same_tree(tmp_path / "port", tmp_path / "jax")
    assert len(os.listdir(tmp_path / "port" / "pseudo")) == 3


def _metrics(path, rng):
    with open(path, "w") as f:
        for i in range(23):
            rec = {"step": i, "loss": float(rng.normal() + 5 - 0.1 * i)}
            if i % 5 == 0:
                rec = {"step": i, "val/miou": float(rng.random())}
            f.write(json.dumps(rec) + "\n")


def test_loss_windows_and_series_equal_jax(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    _metrics(path, np.random.default_rng(0))
    for frac in (0.2, 0.5, 0.01):
        assert soak._loss_windows(path, frac) == jax_soak._loss_windows(path, frac)
    assert soak._series(path, "val/miou") == jax_soak._series(path, "val/miou")
    with pytest.raises(AssertionError, match="no 'missing'"):
        soak._series(path, "missing")
    # the translator soaks' windows: JAX's first and last ``len // 5``
    values = list(np.random.default_rng(1).normal(size=64))
    for n in range(1, 65):
        k = max(n // 5, 1)
        assert soak._head_tail(values[:n]) == (float(np.mean(values[:n][:k])),
                                               float(np.mean(values[:n][-k:])))


@pytest.mark.parametrize("ncls", [16, 19])
def test_onchip_banded_labels_are_jax_rule(ncls):
    rng = np.random.default_rng(ncls)
    img = (0.5 * rng.normal(size=(2, 64, 96, 3))).astype(np.float32)
    img[0, 0, :8] = [[k / 8 - ncls / 16, 0.0, 0.0] for k in range(8)]  # near band edges
    j = jnp.asarray(img)
    want = np.asarray(jnp.clip((j.mean(-1) * 8 + ncls / 2).astype(jnp.int32), 0, ncls - 1))
    got = soak.banded_labels(torch.from_numpy(img), ncls)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    want_p = np.asarray(jnp.where(j[..., 0] > 0.64, 255, jnp.asarray(want)))
    np.testing.assert_array_equal(soak.banded_pseudo_labels(torch.from_numpy(img), ncls).numpy(),
                                  want_p)
    assert 0.05 < float((want_p == 255).mean()) < 0.15


def _soak(tmp_path, preset, steps, *extra):
    return soak.main(["--preset", preset, "--tiny", "--device", "cpu", "--steps", str(steps),
                      "--work_dir", str(tmp_path / "soak"), *extra])


def test_translator_soak_tiny(tmp_path, capsys):
    out = _soak(tmp_path, "gta2city_translator", 40)
    assert out["tail"] < out["head"] and out["d_max"] < 4.0
    assert "translator soak ok: 40 steps (export/reload/continue at 20)" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "soak" / "weights_mid")) == sorted(
        f"{r}.pth" for r in ("enc_s", "enc_t", "dec_s2t", "dec_t2s", "dis_s2t", "dis_t2s"))
    with open(tmp_path / "soak" / "metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [0, 25]


@pytest.fixture
def tiny_onchip_presets(monkeypatch):
    """Tiny copies of the warm-up and translator presets for the onchip mode."""
    for name, extra in (("gta2city_warmup", {"layers": (1, 1, 1, 1)}),
                        ("gta2city_translator", {"enc_dim": 8, "dec_dim": 32, "n_res": 1,
                                                 "dis_dim": 8, "dis_layers": 2,
                                                 "dis_scales": 2})):
        p = presets.get_preset(name)
        monkeypatch.setitem(presets.PRESETS, f"tiny_onchip_{name}", dataclasses.replace(
            p, data=dataclasses.replace(
                p.data, source_streams=(presets.LoaderSpec("gta5", (32, 64), 1),),
                target_streams=(presets.LoaderSpec("cityscapes", (32, 64), 1),)),
            train=dataclasses.replace(p.train, crop_hw=(32, 64), compute_dtype="float32"),
            extra={**p.extra, **extra}))


@pytest.mark.parametrize("preset,steps", [("gta2city_warmup", 8), ("gta2city_translator", 40)])
def test_onchip_soak_runs_on_the_cpu(tmp_path, capsys, tiny_onchip_presets, preset, steps):
    out = soak.main(["--preset", f"tiny_onchip_{preset}", "--mode", "onchip", "--device", "cpu",
                     "--steps", str(steps), "--work_dir", str(tmp_path)])
    text = capsys.readouterr().out
    log = "soak_onchip_translator.jsonl" if "translator" in preset else "soak_onchip.jsonl"
    with open(tmp_path / log) as f:
        recs = [json.loads(line) for line in f]
    assert recs[-1]["step"] == steps - 1 and recs[-1]["imgs_per_sec"] > 0
    assert out["imgs_per_sec"] > 0
    assert f"soak ok: {steps} steps" in text


@pytest.mark.slow
@pytest.mark.parametrize("preset,steps", [("dg_gta5", 80), ("gta2city_selftrain", 140)])
def test_fixture_soak_tiny(tmp_path, capsys, preset, steps):
    out = _soak(tmp_path, preset, steps)
    assert out["tail"] < out["head"] and out["best_miou"] >= out["first_miou"]
    assert f"soak ok: {steps} steps" in capsys.readouterr().out
    wd = tmp_path / "soak"
    assert os.path.exists(wd / "metrics.jsonl") and os.path.exists(wd / "ckpt_soak" / "state.pth")
    if preset == "gta2city_selftrain":
        assert len(os.listdir(wd / "data" / "city" / "pseudo")) == 6
