"""The port's datasets and fixtures against the JAX package's.

Same files through ``diga_tpu.data`` and ``diga_tpu_torch.data``: images
(normalized BGR), trainId labels and pseudo-labels (palette PNGs, through
the same resize and geometric transforms driven by the same numpy
generator) must be equal bit for bit, and the port's fixtures must write
the same pixels as the JAX package's.
"""

import os

import numpy as np
import pytest
from PIL import Image

import diga_tpu.data as jax_data
from diga_tpu.data import synthetic as jax_synthetic
import diga_tpu_torch.data as port_data
from diga_tpu_torch.data import synthetic as port_synthetic


def _flat(root, max_label):
    return jax_synthetic.make_flat_fixture(root, n=2, h=36, w=64, max_label=max_label)


@pytest.mark.parametrize("kind", ["cityscapes", "bdd", "mapillary", "bdd_bare", "mapillary_bare"])
def test_val_datasets_match_jax(tmp_path, kind):
    root = str(tmp_path / kind)
    ctor = kind.split("_")[0]
    if kind == "cityscapes":
        lists = jax_synthetic.make_cityscapes_fixture(root, n=2, h=40, w=72, split="val")
    elif kind == "bdd":
        lists = _flat(root, 19)
    elif kind == "mapillary":
        lists = _flat(root, 66)
    elif kind == "bdd_bare":
        lists = jax_synthetic.make_bdd_reference_fixture(root, n=2)
    else:
        lists = jax_synthetic.make_mapillary_reference_fixture(root, n=2)
    ref = getattr(jax_data, f"{ctor}_dataset")(root, *lists, resize_hw=(24, 40))
    ours = getattr(port_data, f"{ctor}_dataset")(root, *lists, resize_hw=(24, 40))
    assert len(ours) == len(ref) == 2
    for i in range(2):
        a, b = ours[i], ref[i]
        assert a["name"] == b["name"]
        assert a["image"].dtype == b["image"].dtype == np.float32
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])


@pytest.mark.parametrize("fixture", ["cityscapes", "flat"])
def test_fixtures_write_the_same_files(tmp_path, fixture):
    for pkg, side in ((port_synthetic, "port"), (jax_synthetic, "jax")):
        if fixture == "cityscapes":
            pkg.make_cityscapes_fixture(str(tmp_path / side), n=2, h=20, w=36)
        else:
            pkg.make_flat_fixture(str(tmp_path / side), n=2, max_label=66)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*") if p.is_file())
    for rel in files:
        if rel.suffix == ".txt":
            assert (tmp_path / "port" / rel).read_text() == (tmp_path / "jax" / rel).read_text()
        else:
            np.testing.assert_array_equal(np.array(Image.open(tmp_path / "port" / rel)),
                                          np.array(Image.open(tmp_path / "jax" / rel)))


def _write_pseudo(root, img_list, hw, seed=0):
    """Palette pseudo-label PNGs named like the generator's output, with
    some out-of-range ids (they load as 255)."""
    from diga_tpu_torch.data.label_maps import CITYSCAPES_COLORS_19, make_png_palette

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "pseudo"), exist_ok=True)
    for line in open(img_list):
        lbl = rng.integers(0, 19, size=hw).astype(np.uint8)
        lbl[::3] = 200
        img = Image.fromarray(lbl).convert("P")
        img.putpalette(make_png_palette(CITYSCAPES_COLORS_19))
        img.save(os.path.join(root, "pseudo", os.path.basename(line.strip())))


@pytest.mark.parametrize("transform", ["none", "flip_sized_crop", "flip_crop"])
def test_pseudo_labels_load_like_jax(tmp_path, transform):
    from diga_tpu.data import transforms as jax_tf
    from diga_tpu_torch.data import transforms as port_tf
    from diga_tpu_torch.data.loader import collate

    root = str(tmp_path / "city")
    img_list, lbl_list = port_synthetic.make_cityscapes_fixture(root, n=2, h=40, w=72,
                                                                split="train")
    _write_pseudo(root, img_list, (40, 72))

    def make(pkg, tf):
        kw = {}
        if transform != "none":
            crop = tf.RandomSizedAndCrop if transform == "flip_sized_crop" else tf.RandomCrop
            kw["transform"] = tf.Compose([tf.RandomHorizontallyFlip(), crop([32, 64])])
        return pkg.cityscapes_dataset(root, img_list, lbl_list, split="train",
                                      pseudo_dir="pseudo", resize_hw=(48, 80), **kw)

    ours, ref = make(port_data, port_tf), make(jax_data, jax_tf)
    samples = []
    for i in range(2):
        a = ours.__getitem__(i, rng=np.random.default_rng(7 + i))
        b = ref.__getitem__(i, rng=np.random.default_rng(7 + i))
        assert ours.pseudo_path(i) == ref.pseudo_path(i)
        for k in ("image", "label", "pseudo"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["pseudo"].dtype == np.uint8 and (a["pseudo"] == 255).any()
        assert a["pseudo"].shape == ((48, 80) if transform == "none" else (32, 64))
        samples.append(a)
    batch = collate(samples)
    assert batch["pseudo"].dtype == batch["label"].dtype == np.int32
    assert batch["pseudo"].shape == (2, *samples[0]["pseudo"].shape)
