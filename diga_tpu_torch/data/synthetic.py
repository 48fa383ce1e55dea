"""Synthetic fixtures for tests and the on-card smoke run.

The port's own copy of ``diga_tpu/data/synthetic.py``: GTA5-, SYNTHIA-
and Cityscapes-shaped directory trees of PNGs with known label
histograms, the flat layout the BDD/Mapillary loaders read, the
reference-layout BDD and Mapillary trees with bare-id lists, and the
palette pseudo-label PNGs of the self-training stage.  Same seeds, same
pixels as the JAX package's fixtures (JPEGs decode equal).
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from .label_maps import (CITYSCAPES_COLORS_19, CITYSCAPES_ID_TO_TRAINID, SYNTHIA_ID_TO_TRAINID,
                         make_png_palette)


def _blocky_label(rng: np.random.Generator, h: int, w: int, ids: list[int]) -> np.ndarray:
    """Label map of horizontal bands drawn from ``ids`` (raw labelIds)."""
    n_bands = rng.integers(3, 6)
    bands = rng.choice(ids, size=n_bands, replace=True)
    lbl = np.zeros((h, w), dtype=np.uint8)
    edges = np.linspace(0, h, n_bands + 1).astype(int)
    for b, (y0, y1) in zip(bands, zip(edges[:-1], edges[1:])):
        lbl[y0:y1] = b
    return lbl


def _write_lists(root: str, prefix: str, img_names: list[str],
                 lbl_names: list[str]) -> tuple[str, str]:
    img_list = os.path.join(root, f"{prefix}_img.txt")
    lbl_list = os.path.join(root, f"{prefix}_lbl.txt")
    for path, names in ((img_list, img_names), (lbl_list, lbl_names)):
        with open(path, "w") as f:
            f.write("\n".join(names) + "\n")
    return img_list, lbl_list


def make_gta5_fixture(root: str, n: int = 4, h: int = 64, w: int = 128, seed: int = 0) -> str:
    """images/<name>.png + labels/<name>.png + list file; returns the list path."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    raw_ids = list(CITYSCAPES_ID_TO_TRAINID.keys())
    names = []
    for i in range(n):
        name = f"{i:05d}.png"
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        lbl = _blocky_label(rng, h, w, raw_ids)
        Image.fromarray(img).save(os.path.join(root, "images", name))
        Image.fromarray(lbl).save(os.path.join(root, "labels", name))
        names.append(name)
    list_path = os.path.join(root, "train.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(names) + "\n")
    return list_path


def make_synthia_fixture(root: str, n: int = 3, h: int = 64, w: int = 128, seed: int = 2) -> str:
    """RGB/<name>.png + GT/LABELS/<name>.png (uint16 grayscale label ids) +
    list file; returns the list path.  The real SYNTHIA GT is a 3-channel
    uint16 PNG with the class id in channel 0, which PIL cannot write; the
    reader takes both."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "RGB"), exist_ok=True)
    os.makedirs(os.path.join(root, "GT", "LABELS"), exist_ok=True)
    ids = list(SYNTHIA_ID_TO_TRAINID.keys())
    names = []
    for i in range(n):
        name = f"{i:07d}.png"
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        lbl16 = _blocky_label(rng, h, w, ids).astype(np.uint16)
        Image.fromarray(img).save(os.path.join(root, "RGB", name))
        Image.fromarray(lbl16, mode="I;16").save(os.path.join(root, "GT", "LABELS", name))
        names.append(name)
    list_path = os.path.join(root, "train.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(names) + "\n")
    return list_path


def make_flat_fixture(root: str, n: int = 2, h: int = 48, w: int = 64,
                      max_label: int = 19, seed: int = 3) -> tuple[str, str]:
    """Flat images+labels layout used by the BDD/Mapillary loaders."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "labels"), exist_ok=True)
    img_names, lbl_names = [], []
    for i in range(n):
        img_name = f"images/{i:05d}.jpg"
        lbl_name = f"labels/{i:05d}.png"
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        lbl = rng.integers(0, max_label, size=(h, w)).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, img_name), quality=95)
        Image.fromarray(lbl).save(os.path.join(root, lbl_name))
        img_names.append(img_name)
        lbl_names.append(lbl_name)
    return _write_lists(root, "val", img_names, lbl_names)


def make_cityscapes_fixture(
    root: str, n: int = 4, h: int = 64, w: int = 128, seed: int = 1, split: str = "val"
) -> tuple[str, str]:
    """leftImg8bit/<split>/... + gtFine/<split>/...; returns (img_list, lbl_list)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "leftImg8bit", split, "city"), exist_ok=True)
    os.makedirs(os.path.join(root, "gtFine", split, "city"), exist_ok=True)
    raw_ids = list(CITYSCAPES_ID_TO_TRAINID.keys()) + [0]  # 0 -> ignore
    img_names, lbl_names = [], []
    for i in range(n):
        img_name = f"city/{i:05d}_leftImg8bit.png"
        lbl_name = f"city/{i:05d}_gtFine_labelIds.png"
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        lbl = _blocky_label(rng, h, w, raw_ids)
        Image.fromarray(img).save(os.path.join(root, "leftImg8bit", split, img_name))
        Image.fromarray(lbl).save(os.path.join(root, "gtFine", split, lbl_name))
        img_names.append(img_name)
        lbl_names.append(lbl_name)
    return _write_lists(root, split, img_names, lbl_names)


def make_pseudo_fixture(city_root: str, img_list_path: str, h: int, w: int,
                        seed: int = 0, dirname: str = "pseudo") -> str:
    """Palette pseudo-label PNGs named like the reference generator's output
    (pseudolabel_generator.py:100-105), one per image of the list; returns
    the pseudo dir's name, relative to ``city_root``."""
    rng = np.random.default_rng(seed)
    out = os.path.join(city_root, dirname)
    os.makedirs(out, exist_ok=True)
    palette = make_png_palette(CITYSCAPES_COLORS_19)
    with open(img_list_path) as f:
        names = [os.path.basename(line.strip()) for line in f]
    for name in names:
        if not name:
            continue
        img = Image.fromarray(rng.integers(0, 19, size=(h, w)).astype(np.uint8)).convert("P")
        img.putpalette(palette)
        img.save(os.path.join(out, name))
    return dirname


def _reference_fixture(root: str, img_dir: str, lbl_dir: str, ids: list[str], lbl_suffix: str,
                       h: int, w: int, max_label: int, seed: int) -> tuple[str, str]:
    """JPEG images and PNG labels under ``img_dir``/``lbl_dir`` with the
    same bare-id list twice (val.txt, val_label.txt)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, img_dir), exist_ok=True)
    os.makedirs(os.path.join(root, lbl_dir), exist_ok=True)
    for i in ids:
        img = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        lbl = rng.integers(0, max_label, size=(h, w)).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(root, img_dir, i + ".jpg"), quality=95)
        Image.fromarray(lbl).save(os.path.join(root, lbl_dir, i + lbl_suffix))
    img_list, lbl_list = os.path.join(root, "val.txt"), os.path.join(root, "val_label.txt")
    for path in (img_list, lbl_list):
        with open(path, "w") as f:
            f.write("\n".join(ids) + "\n")
    return img_list, lbl_list


def make_bdd_reference_fixture(root: str, n: int = 2, h: int = 48, w: int = 64,
                               seed: int = 4) -> tuple[str, str]:
    """Reference-layout BDD100k val fixture: images/val/<id>.jpg +
    gtFine/val/<id>_train_id.png and bare-id lists (BDDLoader.py:66-67)."""
    return _reference_fixture(root, os.path.join("images", "val"), os.path.join("gtFine", "val"),
                              [f"{i:08x}-00000000" for i in range(n)], "_train_id.png",
                              h, w, 19, seed)


def make_mapillary_reference_fixture(root: str, n: int = 2, h: int = 48, w: int = 64,
                                     seed: int = 5) -> tuple[str, str]:
    """Reference-layout Mapillary val fixture: validation/images/<id>.jpg +
    validation/labels/<id>.png and bare-id lists (MapillaryLoader.py:165-166)."""
    return _reference_fixture(root, os.path.join("validation", "images"),
                              os.path.join("validation", "labels"),
                              [f"fixture_{i:04d}_id" for i in range(n)], ".png", h, w, 66, seed)
