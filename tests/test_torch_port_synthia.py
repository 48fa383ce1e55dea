"""SYNTHIA->Cityscapes in the port against the JAX package, on the CPU.

* The SYNTHIA label reader and fixture: the port's fixture writes the JAX
  package's files; on its 16-bit grayscale labels the port's reader returns
  what ``diga_tpu``'s ``_synthia_lbl_reader`` returns.  On a 3-channel
  16-bit PNG (written with OpenCV: imageio cannot write one) the port
  returns channel 0 at its full 16 bits; the JAX reader is not the oracle
  there, because imageio reads such a PNG through PIL at 8 bits.  With no
  OpenCV, a PNG of more than one channel raises, naming the file.
* ``synthia_dataset`` and ``gta5_dataset`` train samples (resize, flip,
  random-sized crop, rare-class resampling) and the ``BatchLoader`` /
  ``MultiStreamLoader`` batches of the GTA5 and SYNTHIA source streams,
  and the BDD/Mapillary target streams, equal to JAX's bit for bit, one
  numpy seed on both sides.
* ``ohem_cross_entropy``, value at rel 1e-5 and gradient within 1e-5
  relative + 1e-6 x max|grad|, against JAX's: ``min_kept`` below and
  above the valid count, a batch that is all ignore (loss 0, gradient 0),
  ties at the threshold, 16 and 19 classes, bf16 logits.
* 5 SYNTHIA warm-up steps (16 classes, OHEM at the presets' thresh 0.7
  and min_kept 100 000, the LR warm-up over 3 of the 5 steps, the ``diga``
  chain at beta 0.4 with ColorJitter p 0.7, the JAX draws injected) and 5
  SYNTHIA self-training steps (OHEM on the source and the DACS image; the
  JAX side in a subprocess, ``tests/_torch_port_selftrain_ref.py``), held
  every step at atol 1e-5 / rtol 1e-4 (``tests/_torch_port_steps.py``).
  On a 32x64 crop's 3584 valid pixels the presets' min_kept keeps every
  valid pixel under 0.7, so these runs hold OHEM's wiring and its
  normalisation by the kept count; the selection below the valid count is
  held by the unit tests above (a random tiny model's probabilities lie
  about 1e-6 apart, within the two packages' f32 difference of any rank).
* The CLIs: ``calc_centroids --source`` on SYNTHIA gives the JAX CLI's
  centroids within 1e-5 (the JAX CLI's CrDoMix draws replayed into the
  port's); ``make_step_config`` of the ``synthia2city_*`` presets, and of
  ``--parity`` on every preset the port trains, equals JAX's field for
  field; the SYNTHIA chain (warm-up -> pseudo-labels -> centroids ->
  self-training -> 16-class eval) and a ``--parity`` warm-up run end to
  end with finite losses.
"""

import dataclasses
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import diga_tpu.cli.calc_centroids as jax_calc_centroids
import diga_tpu.data as jax_data
from diga_tpu.cli import common as jax_common
from diga_tpu.configs import presets as jax_presets
from diga_tpu.data import datasets as jax_datasets
from diga_tpu.data import synthetic as jax_synthetic
from diga_tpu.data import transforms as jax_transforms
from diga_tpu.models.convert import segmodel_to_torch
from diga_tpu.ops import losses as jax_losses
from diga_tpu.ops import mixing as jax_mixing
from diga_tpu.train import loop as jax_loop
from diga_tpu.train.build import make_step_config as jax_make_step_config
from diga_tpu.utils.checkpoint import export_role_keyed
import diga_tpu_torch.cli.calc_centroids as calc_centroids
import diga_tpu_torch.cli.evaluate_val as evaluate_val
import diga_tpu_torch.cli.pseudolabel_generator as pseudolabel_generator
import diga_tpu_torch.cli.train_self_training as train_self_training
import diga_tpu_torch.cli.train_warm_up as train_warm_up
import diga_tpu_torch.data as port_data
from diga_tpu_torch.cli import common as port_common
from diga_tpu_torch.configs import presets as port_presets
from diga_tpu_torch.data import synthetic as port_synthetic
from diga_tpu_torch.data import transforms as port_transforms
from diga_tpu_torch.data.label_maps import SYNTHIA_COLORS_16, make_png_palette
from diga_tpu_torch.models.translator import ImgDecoder, ImgEncoder
from diga_tpu_torch.ops import losses as port_losses
from diga_tpu_torch.ops import photometric as P
from diga_tpu_torch.ops.prototypes import Centroids
from diga_tpu_torch.train import loop as port_loop
from diga_tpu_torch.train.build import TRAIN_STAGES, make_step_config
from diga_tpu_torch.train.optim import sgd_grouped
from diga_tpu_torch.train.schedules import poly_schedule
from diga_tpu_torch.train.state import create_seg_state
from diga_tpu_torch.train.steps import DISTIL_SCALE, EMA_CAP, StepConfig, build_selftrain_step
from diga_tpu_torch.models.resnet_deeplab import DeepLabV2

import _torch_port_selftrain_ref as st_ref
import _torch_port_steps as steps
from _torch_port_common import LAYERS, jax_tiny_deeplab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 16
HW = (40, 72)


def _no_module(monkeypatch, name):
    """Make ``import name`` raise ImportError inside the test."""
    monkeypatch.setitem(sys.modules, name, None)


# ---------------------------------------------------------------------------
# the label reader and the fixture
# ---------------------------------------------------------------------------

def test_fixture_writes_the_jax_files_and_the_reader_reads_them_alike(tmp_path, monkeypatch):
    lists = {side: pkg.make_synthia_fixture(str(tmp_path / side), n=3, h=20, w=36)
             for side, pkg in (("port", port_synthetic), ("jax", jax_synthetic))}
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert len(files) == 7 and files == sorted(
        p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*") if p.is_file())
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f
    for name in port_data.read_list(lists["port"]):
        path = str(tmp_path / "port" / "GT" / "LABELS" / name)
        assert Image.open(path).mode == "I;16"
        ref = jax_datasets._synthia_lbl_reader(path)
        for cv2_present in (True, False):
            if not cv2_present:
                _no_module(monkeypatch, "cv2")
            ours = port_data.read_synthia_label(path)
            assert ours.mode == ref.mode == "I"
            np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))
        monkeypatch.undo()


def _write_colour_png(path, arr):
    import cv2

    assert cv2.imwrite(path, arr[..., ::-1].copy())  # OpenCV writes BGR(A) order as RGB(A)


@pytest.mark.parametrize("depth", [16, 8])
def test_reader_takes_channel_zero_of_a_colour_png_at_its_depth(tmp_path, depth):
    rng = np.random.default_rng(4)
    dtype = np.uint16 if depth == 16 else np.uint8
    arr = rng.integers(0, 2 ** depth, size=(9, 14, 3)).astype(dtype)
    arr[0, :3, 0] = (3, 21, 300 if depth == 16 else 255)  # SYNTHIA ids, one above 8 bits
    path = str(tmp_path / "lbl.png")
    _write_colour_png(path, arr)
    with open(path, "rb") as f:
        assert f.read(26)[24:26] == bytes((depth, 2))  # IHDR: depth, colour type RGB
    ours = port_data.read_synthia_label(path)
    assert ours.mode == "I"
    np.testing.assert_array_equal(np.asarray(ours), arr[..., 0].astype(np.int32))
    if depth == 8:  # at 8 bits imageio reads it exactly, and the JAX reader agrees
        np.testing.assert_array_equal(np.asarray(ours),
                                      np.asarray(jax_datasets._synthia_lbl_reader(path)))


@pytest.mark.parametrize("what", ["rgb16", "rgb8", "palette", "not_png"])
def test_reader_raises_rather_than_guess_without_opencv(tmp_path, monkeypatch, what):
    path = str(tmp_path / f"{what}.png")
    if what == "not_png":
        with open(path, "wb") as f:
            f.write(b"not an image")
    elif what == "palette":
        img = Image.fromarray(np.zeros((4, 5), np.uint8)).convert("P")
        img.putpalette(make_png_palette(SYNTHIA_COLORS_16))
        img.save(path)
    else:
        _write_colour_png(path, np.ones((4, 5, 3), np.uint16 if what == "rgb16" else np.uint8))
    _no_module(monkeypatch, "cv2")
    with pytest.raises(ValueError, match=re.escape(path)):
        port_data.read_synthia_label(path)


# ---------------------------------------------------------------------------
# train samples and the source streams
# ---------------------------------------------------------------------------

def _pipeline(tp, crop=(24, 40)):
    return tp.Compose([tp.RandomHorizontallyFlip(), tp.RandomSizedAndCrop(list(crop))])


@pytest.mark.parametrize("kind", ["synthia", "gta5"])
def test_train_samples_with_rare_class_resampling_match_jax(tmp_path, kind):
    """Resize, flip, random-sized crop and the rare-class redraws from one
    numpy seed on both sides; crops of a fifth of the height, so that some
    hold fewer than 3 classes and are redrawn."""
    root = str(tmp_path / kind)
    make = getattr(jax_synthetic, f"make_{kind}_fixture")
    lst = make(root, n=3, h=30, w=52)
    redrawn = 0
    for rare in (True, False):
        ref = getattr(jax_data, f"{kind}_dataset")(
            root, lst, resize_hw=(60, 100), transform=_pipeline(jax_transforms, (12, 20)),
            rare_class_resample=rare)
        ours = getattr(port_data, f"{kind}_dataset")(
            root, lst, resize_hw=(60, 100), transform=_pipeline(port_transforms, (12, 20)),
            rare_class_resample=rare)
        assert ours.rare_class_resample == rare
        for i in range(3):
            for seed in range(8):
                a = ours.__getitem__(i, rng=np.random.default_rng(seed))
                b = ref.__getitem__(i, rng=np.random.default_rng(seed))
                assert a["name"] == b["name"]
                np.testing.assert_array_equal(a["image"], b["image"])
                np.testing.assert_array_equal(a["label"], b["label"])
                if rare:
                    plain = ours.__getitem__(i, rng=np.random.default_rng(seed))
                    ours.rare_class_resample = False
                    once = ours.__getitem__(i, rng=np.random.default_rng(seed))
                    ours.rare_class_resample = True
                    redrawn += not np.array_equal(plain["label"], once["label"])
    assert redrawn > 0


def _tiny_data(presets, name, src, src_list):
    """The preset's DataConfig on the source fixture, its resizes cut."""
    base = presets.get_preset(name).data
    streams = tuple(dataclasses.replace(s, resize_hw=hw)
                    for s, hw in zip(base.source_streams, ((30, 52), (36, 64))))
    return dataclasses.replace(base, source_root=src, source_list=src_list,
                               source_streams=streams, num_workers=2)


@pytest.mark.parametrize("preset", ["synthia2city_warmup", "gta2city_warmup"])
def test_source_stream_batches_match_jax(tmp_path, preset):
    """Three batches of the dual-scale source stream (BatchLoader per
    stream, concatenated by MultiStreamLoader), two worker threads each."""
    crop = (24, 40)
    src = str(tmp_path / "src")
    make = (jax_synthetic.make_synthia_fixture if preset.startswith("synthia")
            else jax_synthetic.make_gta5_fixture)
    src_list = make(src, n=3, h=36, w=64)
    loaders = []
    for presets, loop in ((port_presets, port_loop), (jax_presets, jax_loop)):
        data = _tiny_data(presets, preset, src, src_list)
        loaders.append(loop.MultiStreamLoader(
            [(loop.build_dataset(s, data, crop, True), s.batch) for s in data.source_streams],
            seed=5, num_workers=2))
    try:
        its = [iter(ld) for ld in loaders]
        for _ in range(3):
            a, b = (next(it) for it in its)
            n = sum(spec.batch for spec in data.source_streams)  # SYNTHIA 1 + 3, GTA5 1 + 2
            assert a["name"] == b["name"] and len(a["name"]) == n
            assert a["image"].shape == (n, *crop, 3) and a["label"].dtype == np.int32
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])
    finally:
        for ld in loaders:
            ld.stop()


@pytest.mark.parametrize("kind", ["bdd", "mapillary"])
def test_bdd_and_mapillary_target_streams_match_jax(tmp_path, kind):
    root = str(tmp_path / kind)
    img_list, lbl_list = jax_synthetic.make_flat_fixture(root, n=2, h=36, w=64,
                                                         max_label=66 if kind == "mapillary" else 19)
    samples = []
    for presets, loop in ((port_presets, port_loop), (jax_presets, jax_loop)):
        data = dataclasses.replace(presets.get_preset("dg_gta5").data, target_root=root,
                                   target_img_list=img_list, target_lbl_list=lbl_list)
        spec = presets.LoaderSpec(kind, (30, 52), 1)
        ds = loop.build_dataset(spec, data, (24, 40), False)
        samples.append([ds.__getitem__(i, rng=np.random.default_rng(i)) for i in range(2)])
    for a, b in zip(*samples):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])


def test_cityscapes_source_stream_is_still_refused(tmp_path):
    """The Cityscapes source stream of the semi-supervised presets, refused
    until the port had HRNet, now builds and matches the JAX package's
    sample for sample: images from ``source_root``/``source_list``, labels
    from ``target_lbl_list`` paired by position.  What stays refused on such
    a source is ``calc_centroids --source``
    (tests/test_torch_port_semiseg_cli.py)."""
    root = str(tmp_path / "city")
    img_list, lbl_list = jax_synthetic.make_cityscapes_fixture(root, n=2, h=36, w=64,
                                                               split="train")
    samples = []
    for presets, loop in ((port_presets, port_loop), (jax_presets, jax_loop)):
        data = dataclasses.replace(presets.get_preset("semiseg_1_8_warmup").data,
                                   source_root=root, source_list=img_list,
                                   target_lbl_list=lbl_list)
        spec = data.source_streams[0]
        assert spec.kind == "cityscapes" and data.source_lbl_list is None
        ds = loop.build_dataset(dataclasses.replace(spec, resize_hw=(30, 52)), data, (24, 40),
                                True)
        samples.append([ds.__getitem__(i, rng=np.random.default_rng(i)) for i in range(2)])
    for a, b in zip(*samples):
        assert a["name"] == b["name"] and a["image"].shape == (24, 40, 3)
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])


# ---------------------------------------------------------------------------
# OHEM
# ---------------------------------------------------------------------------

OHEM_CASES = ["below_16", "below_19", "above_16", "above_19", "all_ignore", "ties_16"]


def _ohem_case(case):
    """(logits (B, H, W, K) f32, labels int32, thresh, min_kept)."""
    rng = np.random.default_rng(sorted(OHEM_CASES).index(case))
    k = 19 if case.endswith("19") else 16
    logits = (rng.normal(size=(2, 16, 24, k)) * 2.0).astype(np.float32)
    labels = rng.integers(0, k, size=(2, 16, 24)).astype(np.int32)
    labels[:, :3] = 255  # 2 x 13 x 24 = 624 valid pixels
    if case.startswith("below"):
        return logits, labels, 0.7, 100
    if case.startswith("above"):
        return logits, labels, 0.7, 100_000
    if case == "all_ignore":
        return logits, np.full_like(labels, 255), 0.7, 100
    # ties: 100 hard pixels (p ~ 0.12), 200 tied at p ~ 0.5 where the
    # min_kept-th falls, the rest easy; thresh below the tie, so the
    # threshold is the tied probability and the strict < drops all 200
    labels = np.zeros((2, 16, 24), np.int32)
    flat = logits.reshape(-1, k)
    flat[:] = 0.0
    flat[:100, 0] = 0.0
    flat[:100, 1] = 2.0
    flat[100:300, 0] = math.log(k - 1)
    flat[300:, 0] = 8.0
    return logits, labels, 0.3, 150


def _ohem_both(logits, labels, thresh, min_kept):
    lt = torch.from_numpy(logits).requires_grad_(True)
    ours = port_losses.ohem_cross_entropy(lt, torch.from_numpy(labels), thresh, min_kept)
    ours.backward()
    fn = lambda lg: jax_losses.ohem_cross_entropy(lg, jnp.asarray(labels), thresh, min_kept)
    ref, ref_grad = jax.value_and_grad(fn)(jnp.asarray(logits))
    return ours, lt.grad, float(ref), np.asarray(ref_grad)


@pytest.mark.parametrize("case", OHEM_CASES)
def test_ohem_value_and_gradient_match_jax(case):
    logits, labels, thresh, min_kept = _ohem_case(case)
    ours, grad, ref, ref_grad = _ohem_both(logits, labels, thresh, min_kept)
    assert ours.dtype == torch.float32
    assert float(ours.detach()) == pytest.approx(ref, rel=1e-5, abs=1e-7)
    np.testing.assert_allclose(grad.numpy(), ref_grad, rtol=1e-5,
                               atol=1e-6 * max(np.abs(ref_grad).max(), 1e-30))
    if case == "all_ignore":
        assert float(ours.detach()) == 0.0 and not grad.any()
    if case == "ties_16":  # only the 100 hard pixels are kept
        kept = grad.abs().sum(-1).reshape(-1) > 0
        assert int(kept.sum()) == 100 and bool(kept[:100].all())


def test_ohem_runs_in_f32_under_bf16_autocast():
    logits, labels, thresh, min_kept = _ohem_case("below_16")
    lb = torch.from_numpy(logits).to(torch.bfloat16)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        ours = port_losses.ohem_cross_entropy(lb, torch.from_numpy(labels), thresh, min_kept)
    ref = jax_losses.ohem_cross_entropy(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels),
                                        thresh, min_kept)
    assert ours.dtype == torch.float32
    assert float(ours) == pytest.approx(float(ref), rel=1e-5)


# ---------------------------------------------------------------------------
# 5 SYNTHIA warm-up and self-training steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def warmup_trajectories():
    return steps.run_steps("warmup", K=K, lr_warmup=3, beta=0.4, p_jitter=0.7, seg_loss="ohem")


@pytest.mark.parametrize("what", steps.WHAT)
def test_synthia_warmup_step_matches_jax_every_step(warmup_trajectories, what):
    steps.check(warmup_trajectories, what)


def _part(npz, prefix: str) -> dict:
    return {k.split("|", 1)[1]: torch.from_numpy(npz[k]) for k in npz.files
            if k.startswith(prefix + "|")}


@pytest.fixture(scope="module")
def selftrain_trajectories(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("synthia_selftrain_ref"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.path.join(REPO, "tests"), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tests",
                                                        "_torch_port_selftrain_ref.py"),
                           out, "synthia"], capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    init = np.load(os.path.join(out, "init.npz"))
    variant = st_ref.VARIANTS["synthia"]
    k = variant["num_classes"]
    student = DeepLabV2(num_classes=k, layers=st_ref.LAYERS, droprate=0.0)
    student.load_state_dict(_part(init, "student"), strict=True)
    enc, dec = ImgEncoder(**st_ref.TRANSLATOR["enc"]), ImgDecoder(**st_ref.TRANSLATOR["dec"])
    enc.load_state_dict(_part(init, "enc_s"), strict=True)
    dec.load_state_dict(_part(init, "dec_s2t"), strict=True)
    cents = _part(init, "centroids")
    state = create_seg_state(student, sgd_grouped(student, st_ref.LR, momentum=0.9,
                                                  weight_decay=5e-4, head_mult=10.0), seed=0,
                             translator=torch.nn.ModuleDict({"enc_s": enc, "dec_s2t": dec}),
                             centroids=Centroids(cents["vectors"], cents["counts"]))
    state.teacher.load_state_dict(_part(init, "teacher"), strict=True)
    cfg = StepConfig(num_classes=k, crop_hw=st_ref.CROP, beta=0.0,
                     lambda_distil=st_ref.LAMBDA_DISTIL, compute_dtype=torch.float32,
                     **variant["step"])
    step = build_selftrain_step(cfg, poly_schedule(st_ref.LR, 1000))
    out_steps = []
    for i in range(st_ref.N_STEPS):
        want = np.load(os.path.join(out, f"step{i}.npz"))
        metrics = step(state, {kk: torch.from_numpy(v)
                               for kk, v in st_ref.make_batch(i, k).items()},
                       selection=torch.from_numpy(want["selection|crdomix"]),
                       dacs_selection=torch.from_numpy(want["selection|dacs"]))
        mu = {kk: state.optimizer.state[p]["momentum_buffer"].clone()
              for kk, p in state.student.named_parameters() if p.requires_grad}
        out_steps.append({"want": want, "metrics": {kk: float(v) for kk, v in metrics.items()},
                          "student": {kk: v.clone() for kk, v in state.student.state_dict().items()},
                          "teacher": {kk: v.clone() for kk, v in state.teacher.state_dict().items()},
                          "mu": mu, "centroids": state.centroids})
    return out_steps


@pytest.mark.parametrize("what", ["metrics", "student", "teacher", "momentum", "centroids"])
def test_synthia_selftrain_step_matches_jax_every_step(selftrain_trajectories, what):
    for i, t in enumerate(selftrain_trajectories):
        if what == "metrics":
            for m, v in t["metrics"].items():
                want = float(t["want"][f"metric|{m}"])
                assert v == pytest.approx(want, rel=steps.RTOL, abs=steps.ATOL), (i, m)
            continue
        if what == "centroids":
            want = _part(t["want"], "centroids")
            np.testing.assert_array_equal(t["centroids"].counts.numpy(), want["counts"].numpy())
            steps._close(t["centroids"].vectors, want["vectors"], f"step {i} centroids")
            continue
        want = _part(t["want"], "mu" if what == "momentum" else what)
        ours = t["mu" if what == "momentum" else what]
        keys = [k for k in ours if not k.endswith("num_batches_tracked")]
        assert keys
        for k in keys:
            steps._close(ours[k], want[k], f"step {i} {what} {k}")


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def _step_config_fields(ours, ref, jax_cfg):
    for field in ("num_classes", "crop_hw", "beta", "lambda_seg", "lambda_distil", "seg_loss",
                  "ohem_thresh", "ohem_min_kept", "photometric", "p_jitter", "with_sharpness",
                  "tgt_stats_forward"):
        assert getattr(ours, field) == getattr(ref, field), field
    # what the port's StepConfig holds as constants, or leaves to the semiseg slice
    assert (ref.ema_cap, ref.distil_scale) == (EMA_CAP, DISTIL_SCALE)
    assert (ref.aux_weight, ref.rgb_input, ref.use_crdomix, ref.fuse_forwards) == \
        (0.0, False, True, False)
    assert ours.compute_dtype == {"float32": torch.float32,
                                  "bfloat16": torch.bfloat16}[jax_cfg.train.compute_dtype]


TRAINED = sorted(n for n, c in port_presets.PRESETS.items()
                 if c.stage in TRAIN_STAGES and "model" not in c.extra)


@pytest.mark.parametrize("parity", [False, True], ids=["preset", "parity"])
@pytest.mark.parametrize("preset", TRAINED)
def test_step_config_matches_jax_field_for_field(preset, parity):
    argv = ["--preset", preset] + (["--parity"] if parity else [])
    port_cfg = port_common.get_config(port_common.base_parser("t").parse_args(argv))
    jax_cfg = jax_common.get_config(jax_common.base_parser("t").parse_args(argv))
    ours, ref = make_step_config(port_cfg), jax_make_step_config(jax_cfg)
    _step_config_fields(ours, ref, jax_cfg)
    assert ours.photometric == ("kornia" if parity else "diga")
    assert ours.compute_dtype == (torch.float32 if parity else torch.bfloat16)
    if preset.startswith("synthia"):
        assert (ours.num_classes, ours.seg_loss) == (16, "ohem")
        assert ours.p_jitter == (0.7 if preset == "synthia2city_warmup" else 0.5)


def test_trained_presets_include_both_synthia_stages():
    assert {"synthia2city_warmup", "synthia2city_selftrain", "gta2city_warmup",
            "gta2city_selftrain", "dg_gta5"} <= set(TRAINED)


def _tiny(presets, name):
    base = presets.get_preset(name)

    def streams(specs):
        return tuple(dataclasses.replace(s, resize_hw=hw, batch=1)
                     for s, hw in zip(specs, (HW, (48, 80))))

    return dataclasses.replace(
        base,
        data=dataclasses.replace(base.data, num_workers=1,
                                 source_streams=streams(base.data.source_streams),
                                 target_streams=streams(base.data.target_streams)),
        train=dataclasses.replace(base.train, crop_hw=(32, 64), compute_dtype="float32",
                                  remat=False, num_steps=2, eval_every=0),
        eval=presets.EvalConfig(num_classes=base.eval.num_classes, out_hw=HW, ds_hw=(20, 36)),
        extra={**base.extra, "layers": LAYERS})


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """SYNTHIA and Cityscapes fixtures, a student.pth from a 16-class JAX init
    and a seeded translator in a role-keyed weight directory, and tiny
    SYNTHIA presets in both registries (restored afterwards)."""
    tmp = tmp_path_factory.mktemp("synthia_chain")
    syn_list = port_synthetic.make_synthia_fixture(str(tmp / "synthia"), n=2, h=HW[0], w=HW[1])
    img, lbl = port_synthetic.make_cityscapes_fixture(str(tmp / "city"), n=2, h=HW[0], w=HW[1],
                                                      split="train")
    val_img, val_lbl = port_synthetic.make_cityscapes_fixture(str(tmp / "city"), n=1, h=HW[0],
                                                              w=HW[1], split="val")
    # seed 43: its predictions meet the SYNTHIA labels on 5 or more pixels
    # of two classes, so --source centroids are not all zero
    _, params, stats = jax_tiny_deeplab(seed=43, hw=HW, num_classes=K)
    wdir = str(tmp / "given" / "weights")
    with torch.random.fork_rng():
        torch.manual_seed(5)
        translator = {"enc_s": ImgEncoder().state_dict(), "dec_s2t": ImgDecoder().state_dict()}
    export_role_keyed(wdir, {"student": segmodel_to_torch(params, stats, LAYERS), **translator})
    names = {"synthia2city_warmup": "tiny_synthia_warmup",
             "synthia2city_selftrain": "tiny_synthia_st", "gta2city_warmup": "tiny_gta_parity"}
    with pytest.MonkeyPatch.context() as mp:
        for base, tiny in names.items():
            mp.setitem(jax_presets.PRESETS, tiny, _tiny(jax_presets, base))
            mp.setitem(port_presets.PRESETS, tiny, _tiny(port_presets, base))
        data = ["--source_root", str(tmp / "synthia"), "--source_list", syn_list,
                "--target_root", str(tmp / "city"), "--target_img_list", img,
                "--target_lbl_list", lbl]
        yield {"tmp": tmp, "wdir": wdir, "data": data, "city": str(tmp / "city"),
               "val": ["--val_img_list", val_img, "--val_lbl_list", val_lbl]}


def test_calc_centroids_source_on_synthia_matches_jax_cli(chain, monkeypatch):
    """The JAX CLI draws each image's CrDoMix selection from ``split(key)``;
    the port's draws are replaced by the same selections."""
    key = [jax.random.PRNGKey(port_presets.get_preset("tiny_synthia_warmup").train.seed)]

    def replay(labels, generator, k):
        key[0], sub = jax.random.split(key[0])
        return torch.from_numpy(np.array(
            jax_mixing.sample_half_classes(jnp.asarray(labels.numpy()), sub, k)))

    monkeypatch.setattr(calc_centroids, "sample_half_classes", replay)
    outs = {}
    for side, cli, extra in (("port", calc_centroids, ["--device", "cpu"]),
                             ("jax", jax_calc_centroids, [])):
        outs[side] = str(chain["tmp"] / f"cent_src_{side}")
        cli.main(["--preset", "tiny_synthia_warmup", "--weight_dir", chain["wdir"],
                  "--centroid_dir", outs[side], "--epochs", "2", "--source", *chain["data"],
                  *extra])
    ours, ref = (np.load(os.path.join(outs[s], "feat_centroids.npy")) for s in ("port", "jax"))
    assert ours.shape == ref.shape == (K, 256) and np.isfinite(ours).all()
    assert np.abs(ref).sum(axis=1).astype(bool).sum() >= 2  # classes seen
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def _logged(out: str) -> list[dict]:
    return [dict((k, float(v)) for k, v in re.findall(r"(\w+)=([-\d.eE+naif]+)", line))
            for line in out.splitlines() if line.startswith("step ") and "loss=" in line]


def test_synthia_chain_end_to_end(chain, capsys):
    """warm-up -> pseudo-labels -> centroids (target and --source) ->
    self-training -> the 16-class eval, each through its CLI on the CPU."""
    tmp, data, cpu = chain["tmp"], chain["data"], ["--device", "cpu"]
    wu = str(tmp / "wu")
    r = train_warm_up.main(["--preset", "tiny_synthia_warmup", "--work_dir", wu,
                            "--load_weight_dir", chain["wdir"], *data, *cpu])
    assert set(r.last_metrics) == {"loss", "loss_semseg", "loss_distil"}
    assert all(math.isfinite(v) for v in r.last_metrics.values())
    final = os.path.join(wu, "ckpt_final")
    pseudo = os.path.join(chain["city"], "pseudo_train_warm_up")
    assert pseudolabel_generator.main(["--preset", "tiny_synthia_warmup", "--weight_dir", final,
                                       "--output_dir", pseudo, *data, *cpu]) == 2
    for name in os.listdir(pseudo):
        im = Image.open(os.path.join(pseudo, name))
        assert im.mode == "P" and im.getpalette()[:48] == make_png_palette(SYNTHIA_COLORS_16)[:48]
        assert int(np.array(im).max()) < K
    cents = {}
    for src in (False, True):
        cdir = str(tmp / f"cent_{int(src)}")
        c = calc_centroids.main(["--preset", "tiny_synthia_warmup", "--weight_dir", final,
                                 "--centroid_dir", cdir, "--epochs", "1", *data, *cpu]
                                + (["--source"] if src else []))
        cents[src] = os.path.join(cdir, "feat_centroids.npy")
        vec = np.load(cents[src])
        assert vec.shape == (K, 256) and np.isfinite(vec).all()
        assert src or float(c.counts.sum()) > 0  # the source's also needs prediction == label
    capsys.readouterr()
    st = str(tmp / "st")
    r = train_self_training.main(["--preset", "tiny_synthia_st", "--work_dir", st,
                                  "--load_weight_dir", final, "--centroid_path", cents[False],
                                  *data, *cpu])
    logged = _logged(capsys.readouterr().out)
    assert len(logged) == 1 and all(math.isfinite(v) for v in logged[0].values())
    assert set(r.last_metrics) == {"loss", "loss_semseg", "loss_crossmix", "loss_distil",
                                   "consensus_kept"}
    assert all(math.isfinite(v) for v in r.last_metrics.values())
    scores = evaluate_val.main(["--preset", "tiny_synthia_st", "--weight_dir",
                                os.path.join(st, "ckpt_final"), "--target_root",
                                chain["city"], *chain["val"], "--eval_limit", "1", *cpu])
    s = scores["cityscapes"]
    assert {"mean_iou", "mean_iou_13"} <= set(s) and 0.0 <= s["mean_iou_13"] <= 1.0


def test_parity_warmup_runs_the_kornia_chain_in_f32(chain, monkeypatch):
    calls = []
    draw_kornia = P.draw_kornia

    def counted(*args, **kw):
        calls.append(args[1])
        return draw_kornia(*args, **kw)

    monkeypatch.setattr(P, "draw_kornia", counted)
    gta = port_synthetic.make_gta5_fixture(str(chain["tmp"] / "gta"), n=2, h=HW[0], w=HW[1])
    data = ["--source_root", str(chain["tmp"] / "gta"), "--source_list", gta,
            *chain["data"][4:]]
    r = train_warm_up.main(["--preset", "tiny_gta_parity", "--work_dir",
                            str(chain["tmp"] / "parity"), "--parity", *data, "--device", "cpu"])
    assert calls == [2, 2]  # one draw of the 1 + 1 source images per step
    assert all(math.isfinite(v) for v in r.last_metrics.values())
