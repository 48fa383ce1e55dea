"""File-list validation datasets (numpy/PIL).

The port's own copy of the evaluation part of ``diga_tpu/data/datasets.py``:
``SegDataset`` without the training-time augmentation, rare-class
resampling and pseudo-label loading, and the three val constructors.
The JAX package routes the uint8 remap and the normalize through its C
host ops; their numpy forms below give the same values bit for bit.

Reference citations: CityLoader.py:30-138, MapillaryLoader.py:133+,
BDDLoader.py:35+.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
from PIL import Image

from . import label_maps
from .normalize import normalize_image
from .transforms import resize_pair


def read_list(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def _read_image(path: str) -> Image.Image:
    """Decode with OpenCV when available (faster inflate for the big PNGs;
    bit-identical pixels for lossless formats), else PIL."""
    try:
        import cv2

        arr = cv2.imread(path, cv2.IMREAD_COLOR)
        if arr is not None:
            return Image.fromarray(arr[:, :, ::-1])  # BGR -> RGB
    except ImportError:
        pass
    return Image.open(path).convert("RGB")


@dataclasses.dataclass
class SegDataset:
    """Paths + decode + resize + normalize; yields numpy samples.

    Each sample is a dict:
      image:  float32 (H, W, 3) BGR normalized (NHWC layout, see normalize.py)
      label:  uint8   (H, W) trainIds, 255=ignore
      name:   str
    """

    root: str
    img_list: list[str]
    lbl_list: list[str]
    img_template: str = "{name}"
    lbl_template: str = "{name}"
    lut: np.ndarray = dataclasses.field(default_factory=lambda: label_maps.CITYSCAPES_LUT)
    resize_hw: tuple[int, int] | None = None

    def __post_init__(self):
        if len(self.img_list) != len(self.lbl_list):
            raise ValueError(
                f"{len(self.img_list)} images vs {len(self.lbl_list)} labels")

    def __len__(self) -> int:
        return len(self.img_list)

    def img_path(self, i: int) -> str:
        return os.path.join(self.root, self.img_template.format(name=self.img_list[i]))

    def lbl_path(self, i: int) -> str:
        return os.path.join(self.root, self.lbl_template.format(name=self.lbl_list[i]))

    def __getitem__(self, index: int) -> dict:
        image = _read_image(self.img_path(index))
        label = Image.open(self.lbl_path(index))
        if self.resize_hw is not None:
            image, (label,) = resize_pair(image, [label], self.resize_hw)
        lbl_np = label_maps.remap_labels(np.array(label), self.lut)
        return {
            "image": normalize_image(np.array(image)),
            "label": lbl_np.astype(np.uint8),
            "name": self.img_list[index],
        }


def cityscapes_dataset(
    root: str, img_list_path: str, lbl_list_path: str, split: str = "val", **kw
) -> SegDataset:
    """Cityscapes: leftImg8bit/<split>/<name>, gtFine/<split>/<name>.

    reference: CityLoader.py:60-61
    """
    return SegDataset(
        root=root,
        img_list=read_list(img_list_path),
        lbl_list=read_list(lbl_list_path),
        img_template=f"leftImg8bit/{split}/{{name}}",
        lbl_template=f"gtFine/{split}/{{name}}",
        lut=label_maps.CITYSCAPES_LUT,
        **kw,
    )


def _bare_ids(names: list[str]) -> bool:
    """The reference ships BDD/Mapillary lists as bare ids (no extension);
    its loaders expand them with hard-coded templates.  Lists with real
    relative paths keep the plain layout."""
    return bool(names) and "." not in os.path.basename(names[0])


def bdd_dataset(root: str, img_list_path: str, lbl_list_path: str,
                split: str = "val", **kw) -> SegDataset:
    """BDD100k (labels already trainIds).  reference: BDDLoader.py:35+,
    bare ids expand as images/<split>/<id>.jpg + gtFine/<split>/<id>_train_id.png
    (BDDLoader.py:66-67)."""
    imgs, lbls = read_list(img_list_path), read_list(lbl_list_path)
    tpl = {}
    if _bare_ids(imgs):
        tpl = dict(img_template=f"images/{split}/{{name}}.jpg",
                   lbl_template=f"gtFine/{split}/{{name}}_train_id.png")
    return SegDataset(root=root, img_list=imgs, lbl_list=lbls,
                      lut=label_maps.BDD_LUT, **tpl, **kw)


def mapillary_dataset(root: str, img_list_path: str, lbl_list_path: str,
                      split: str = "validation", **kw) -> SegDataset:
    """Mapillary Vistas (66 -> 19 classes).  reference: MapillaryLoader.py:133+,
    bare ids expand as <split>/images/<id>.jpg + <split>/labels/<id>.png
    (MapillaryLoader.py:165-166)."""
    imgs, lbls = read_list(img_list_path), read_list(lbl_list_path)
    tpl = {}
    if _bare_ids(imgs):
        tpl = dict(img_template=f"{split}/images/{{name}}.jpg",
                   lbl_template=f"{split}/labels/{{name}}.png")
    return SegDataset(root=root, img_list=imgs, lbl_list=lbls,
                      lut=label_maps.MAPILLARY_LUT, **tpl, **kw)
