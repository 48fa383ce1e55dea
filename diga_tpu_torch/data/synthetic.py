"""Synthetic val fixtures for tests and the on-card smoke run.

The port's own copy of the val fixtures of ``diga_tpu/data/synthetic.py``:
a Cityscapes-shaped directory tree of PNGs with known label histograms,
and the flat layout the BDD/Mapillary loaders read.  Same seeds, same
pixels as the JAX package's fixtures.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from .label_maps import CITYSCAPES_ID_TO_TRAINID


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
