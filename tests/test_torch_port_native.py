"""The port's C host ops (``utils/native.py`` over ``csrc/host_ops.cpp``) (CPU).

* the library builds into ``diga_tpu_torch/_build/`` and a failed build
  raises with the compiler's output (no quiet numpy fallback), also on the
  train path: ``make_train_iterator`` raises it on the caller's thread,
  and a loader worker's failure reaches its consumer;
* each op is bit-equal to its numpy form (the data path's own
  ``remap_labels`` and ``normalize_image``) and to the JAX package's C path
  (``diga_tpu.utils.native``), the normalize at 512x896 and 1024x2048 too;
  ``fast_hist`` drops predictions outside ``[0, n_class)`` as the C op
  does (JAX's numpy fallback would misindex them, so it is held against
  JAX's C path);
* ``SegDataset`` samples are bit-equal with and without the C ops for
  GTA5, Cityscapes and SYNTHIA, and take the C path exactly where the JAX
  package's do: the remap for uint8 labels with a 256-entry LUT (SYNTHIA's
  int32 label image without a transform keeps the numpy remap; the train
  transform hands every mask on as uint8), the normalize for a uint8 HWC
  RGB image.
"""

import dataclasses
import itertools
import os
import threading

import numpy as np
import pytest

from diga_tpu.utils import native as jax_native
from diga_tpu_torch.configs import presets
from diga_tpu_torch.data import datasets, label_maps, synthetic
from diga_tpu_torch.data.loader import BatchLoader
from diga_tpu_torch.data.normalize import IMG_MEAN_BGR, normalize_image
from diga_tpu_torch.data.transforms import Compose, RandomCrop, RandomHorizontallyFlip
from diga_tpu_torch.train.loop import make_train_iterator
from diga_tpu_torch.utils import native

RNG_SEED = 11


@pytest.fixture(scope="module")
def jax_lib():
    lib = jax_native.get_lib()
    assert lib, "the JAX package's C host ops did not load"
    return lib


def test_library_builds_in_the_port_build_dir():
    lib = native.load()
    assert os.path.exists(native.LIBRARY)
    assert native.LIBRARY.endswith(os.path.join("diga_tpu_torch", "_build", "libhost_ops.so"))
    assert os.path.getmtime(native.LIBRARY) >= os.path.getmtime(native.SOURCE)
    for name in ("remap_u8", "normalize_bgr", "fast_hist", "label_histogram_u8"):
        assert hasattr(lib, name)


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "LIBRARY", str(tmp_path / "libbroken.so"))
    with pytest.raises(RuntimeError, match="broken.cpp"):
        native.build()
    assert not os.path.exists(tmp_path / "libbroken.so")


def _tiny_warmup_cfg(root: str):
    gta = synthetic.make_gta5_fixture(os.path.join(root, "gta"), n=2, h=40, w=72)
    img, lbl = synthetic.make_cityscapes_fixture(os.path.join(root, "city"), n=2, h=40, w=72,
                                                 split="train")
    base = presets.get_preset("gta2city_warmup")
    return dataclasses.replace(base, data=dataclasses.replace(
        base.data, num_workers=1, source_root=os.path.join(root, "gta"), source_list=gta,
        target_root=os.path.join(root, "city"), target_img_list=img, target_lbl_list=lbl,
        source_streams=(presets.LoaderSpec("gta5", (40, 72), 1),),
        target_streams=(presets.LoaderSpec("cityscapes", (40, 72), 1),)),
        train=dataclasses.replace(base.train, crop_hw=(32, 64)))


def test_failed_build_raises_on_the_train_path(monkeypatch, tmp_path):
    """The train iterator's datasets build the C ops on the caller's thread:
    a broken source raises the compiler's error there, before any loader
    worker starts, instead of killing the workers and leaving the loop
    waiting for a batch."""
    cfg = _tiny_warmup_cfg(str(tmp_path))
    bad = tmp_path / "broken.cpp"
    bad.write_text("int main( {\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "LIBRARY", str(tmp_path / "libbroken.so"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build .*broken.cpp"):
        make_train_iterator(cfg, with_target=True)


def test_a_failing_loader_worker_raises_in_its_consumer(tmp_path):
    img, lbl = synthetic.make_cityscapes_fixture(str(tmp_path / "city"), n=2, h=40, w=72)
    ds = datasets.cityscapes_dataset(str(tmp_path / "city"), img, lbl, split="val")
    os.remove(ds.img_path(1))
    loader = BatchLoader(ds, batch_size=1, num_workers=2)
    raised = []

    def consume():  # on its own thread, so that a loader that hangs fails the test
        try:
            for batch in itertools.islice(loader, 4):
                assert batch["image"].shape == (1, 40, 72, 3)
        except RuntimeError as e:
            raised.append(e)

    consumer = threading.Thread(target=consume, daemon=True)
    consumer.start()
    consumer.join(timeout=60.0)
    loader.stop()
    assert not consumer.is_alive(), "the consumer still waits for a batch"
    assert len(raised) == 1 and "loader worker failed" in str(raised[0])
    assert isinstance(raised[0].__cause__, FileNotFoundError)


@pytest.mark.parametrize("lut_name", ["CITYSCAPES_LUT", "GTA5_LUT", "MAPILLARY_LUT", "BDD_LUT"])
def test_remap_u8_bit_equal(jax_lib, lut_name):
    lut = getattr(label_maps, lut_name)
    labels = np.random.default_rng(RNG_SEED).integers(0, 256, size=(97, 131), dtype=np.uint8)
    got = native.remap_u8(labels, lut)
    assert got.dtype == np.uint8
    plain = label_maps.remap_labels(labels, lut)
    assert plain.dtype == np.uint8
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, jax_native.remap_u8(labels, lut))


@pytest.mark.parametrize("hw", [(5, 7), (512, 896), (1024, 2048)])
def test_normalize_bgr_bit_equal(jax_lib, hw):
    rgb = np.random.default_rng(RNG_SEED).integers(0, 256, size=(*hw, 3), dtype=np.uint8)
    got = native.normalize_bgr(rgb, IMG_MEAN_BGR)
    assert got.dtype == np.float32 and got.shape == rgb.shape
    bits = got.view(np.uint32)
    plain = normalize_image(rgb, IMG_MEAN_BGR)
    assert plain.dtype == np.float32
    assert np.array_equal(bits, plain.view(np.uint32))
    assert np.array_equal(bits, jax_native.normalize_bgr(rgb, IMG_MEAN_BGR).view(np.uint32))


def test_normalize_bgr_refuses_other_images():
    with pytest.raises(ValueError, match="uint8"):
        native.normalize_bgr(np.zeros((4, 4, 4), np.uint8), IMG_MEAN_BGR)
    with pytest.raises(ValueError, match="uint8"):
        native.normalize_bgr(np.zeros((4, 4, 3), np.float32), IMG_MEAN_BGR)
    with pytest.raises(ValueError, match="3 channel means"):
        native.normalize_bgr(np.zeros((4, 4, 3), np.uint8), IMG_MEAN_BGR[:2])
    with pytest.raises(ValueError, match="256-entry"):
        native.remap_u8(np.zeros((4, 4), np.uint8), np.zeros(19, np.uint8))


@pytest.mark.parametrize("n_class", [16, 19])
def test_fast_hist_matches_the_jax_c_path(jax_lib, n_class):
    rng = np.random.default_rng(RNG_SEED)
    gt = rng.integers(0, 21, size=(64, 80)).astype(np.int32)
    gt[rng.random(gt.shape) < 0.1] = 255
    pred = rng.integers(-2, n_class + 3, size=(64, 80)).astype(np.int32)  # some out of range
    got = native.fast_hist(gt, pred, n_class)
    assert got.dtype == np.int64 and got.shape == (n_class, n_class)
    np.testing.assert_array_equal(got, jax_native.fast_hist(gt, pred, n_class))
    np.testing.assert_array_equal(got, native.fast_hist_plain(gt, pred, n_class))
    in_range = (gt >= 0) & (gt < n_class) & (pred >= 0) & (pred < n_class)
    assert got.sum() == in_range.sum()


def test_label_histogram_bit_equal(jax_lib):
    labels = np.random.default_rng(RNG_SEED).integers(0, 256, size=(120, 90), dtype=np.uint8)
    got = native.label_histogram(labels)
    np.testing.assert_array_equal(got, native.label_histogram_plain(labels))
    np.testing.assert_array_equal(got, jax_native.label_histogram(labels))
    assert got.sum() == labels.size


def _datasets(root):
    gta = synthetic.make_gta5_fixture(os.path.join(root, "gta"), n=2, h=40, w=72)
    syn = synthetic.make_synthia_fixture(os.path.join(root, "syn"), n=2, h=40, w=72)
    img, lbl = synthetic.make_cityscapes_fixture(os.path.join(root, "city"), n=2, h=40, w=72)
    tf = Compose([RandomHorizontallyFlip(), RandomCrop((32, 64))])
    return {
        "gta5": (datasets.gta5_dataset(os.path.join(root, "gta"), gta, transform=tf), True),
        "synthia": (datasets.synthia_dataset(os.path.join(root, "syn"), syn, transform=tf),
                    True),
        "synthia_eval": (datasets.synthia_dataset(os.path.join(root, "syn"), syn), False),
        "cityscapes": (datasets.cityscapes_dataset(os.path.join(root, "city"), img, lbl,
                                                   split="val"), True),
    }


@pytest.mark.parametrize("kind", ["gta5", "synthia", "synthia_eval", "cityscapes"])
def test_seg_dataset_samples_are_unchanged_by_the_c_ops(tmp_path, monkeypatch, kind):
    ds, remaps_in_c = _datasets(str(tmp_path))[kind]
    calls = {"remap_u8": 0, "normalize_bgr": 0}

    def counted(name):
        fn = getattr(native, name)

        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    with monkeypatch.context() as m:
        for name in calls:
            m.setattr(native, name, counted(name))
        with_c = [ds.__getitem__(i, rng=np.random.default_rng(i)) for i in range(len(ds))]
    assert calls["normalize_bgr"] >= len(ds)
    assert (calls["remap_u8"] > 0) == remaps_in_c
    with monkeypatch.context() as m:
        m.setattr(native, "remap_u8", label_maps.remap_labels)
        m.setattr(native, "normalize_bgr", normalize_image)
        plain = [ds.__getitem__(i, rng=np.random.default_rng(i)) for i in range(len(ds))]
    for a, b in zip(with_c, plain):
        assert a["name"] == b["name"]
        assert a["image"].dtype == np.float32 and a["label"].dtype == np.uint8
        assert np.array_equal(a["image"].view(np.uint32), b["image"].view(np.uint32))
        np.testing.assert_array_equal(a["label"], b["label"])
