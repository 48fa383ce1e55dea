"""File-list segmentation datasets (numpy/PIL).

The port's own copy of ``diga_tpu/data/datasets.py``: ``SegDataset`` with
the training-time geometric augmentation, the rare-class resampling and
the self-training pseudo-labels, and the GTA5, SYNTHIA, Cityscapes, BDD
and Mapillary constructors.  As in the JAX package (:147-170), the remap
of a uint8 label map through a 256-entry LUT and the normalize of a uint8
HWC RGB image run as C host ops (``utils/native.py``); SYNTHIA's uint16
labels and any other image keep the numpy forms, which give the same
values bit for bit.

Reference citations: GTA5Loader.py:35-112, CityLoader.py:30-138,
SYNTHIALoader.py:59-141, MapillaryLoader.py:133+, BDDLoader.py:35+.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
from PIL import Image

from ..utils import native
from . import label_maps
from .normalize import IMG_MEAN_BGR, normalize_image
from .transforms import Compose, resize_pair


# rare-class resampling: a class counts when it covers more than this share
# of the pixels, and a crop is drawn at most this often (GTA5Loader.py:80-106)
RARE_MIN_FRAC = 0.02
RARE_MAX_TRIES = 5


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


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_header(path: str) -> tuple[int, int] | None:
    """(bit depth, colour type) from a PNG's IHDR chunk; None for another format."""
    with open(path, "rb") as f:
        head = f.read(26)
    if len(head) < 26 or head[:8] != _PNG_SIGNATURE or head[12:16] != b"IHDR":
        return None
    return head[24], head[25]


def read_synthia_label(path: str) -> Image.Image:
    """SYNTHIA GT: a uint16 PNG with the class id in channel 0, as an
    int32 ``I`` image (reference: SYNTHIALoader.py:98, imageio's PNG-FI).

    A grayscale PNG is read by PIL, which keeps its 16 bits.  PIL, and
    imageio through it, read a 16-bit colour PNG as 8 bits, so a PNG of
    more than one channel is read by OpenCV, which keeps them, and raises
    where OpenCV is not installed: a label is never cut to 8 bits.
    """
    header = _png_header(path)
    if header is not None and header[1] == 0:  # colour type 0: one gray channel
        arr = np.asarray(Image.open(path))
    else:
        try:
            import cv2
        except ImportError:
            cv2 = None
        arr = None if cv2 is None else cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if arr is None:
            what = ("not a PNG" if header is None
                    else f"a {header[0]}-bit PNG of colour type {header[1]}")
            raise ValueError(
                f"cannot read the SYNTHIA label {path!r} ({what}) without truncating it: "
                "PIL reads only a grayscale PNG at 16 bits, and OpenCV is "
                + ("not installed" if cv2 is None else "unable to decode it"))
        if arr.ndim == 3:
            arr = arr[:, :, 2]  # OpenCV orders the channels BGR(A): the file's first is [2]
    return Image.fromarray(arr.astype(np.int32), mode="I")


@dataclasses.dataclass
class SegDataset:
    """Paths + decode + resize + geometric aug + normalize; yields numpy samples.

    Each sample is a dict:
      image:  float32 (H, W, 3) BGR normalized (NHWC layout, see normalize.py)
      label:  uint8   (H, W) trainIds, 255=ignore
      pseudo: uint8   (H, W) trainIds (only when pseudo_dir is set)
      name:   str

    The pseudo-label PNG, ``<root>/<pseudo_dir>/<basename of the image>``,
    goes through the resize and the geometric transform as a second mask
    beside the label.
    """

    root: str
    img_list: list[str]
    lbl_list: list[str]
    img_template: str = "{name}"
    lbl_template: str = "{name}"
    lut: np.ndarray = dataclasses.field(default_factory=lambda: label_maps.CITYSCAPES_LUT)
    resize_hw: tuple[int, int] | None = None
    transform: Compose | None = None
    rare_class_resample: bool = False
    pseudo_dir: str | None = None
    lbl_reader: Callable[[str], Image.Image] = Image.open

    def __post_init__(self):
        if len(self.img_list) != len(self.lbl_list):
            raise ValueError(
                f"{len(self.img_list)} images vs {len(self.lbl_list)} labels")
        native.load()  # build the C ops here: a failed build raises on this thread

    def __len__(self) -> int:
        return len(self.img_list)

    def img_path(self, i: int) -> str:
        return os.path.join(self.root, self.img_template.format(name=self.img_list[i]))

    def lbl_path(self, i: int) -> str:
        return os.path.join(self.root, self.lbl_template.format(name=self.lbl_list[i]))

    def pseudo_path(self, i: int) -> str:
        return os.path.join(self.root, self.pseudo_dir, os.path.basename(self.img_list[i]))

    def _accept_rare(self, label_trainid: np.ndarray) -> bool:
        """Reference acceptance rule: >=3 classes each covering >2% of the
        pixels, or exactly 2 of which neither is the ignore class
        (GTA5Loader.py:98-106)."""
        cats, counts = np.unique(label_trainid, return_counts=True)
        frac = counts / counts.sum()
        n_pass = int((frac > RARE_MIN_FRAC).sum())
        if n_pass >= 3:
            return True
        if n_pass == 2:
            # cats is sorted, so ignore (255) is last when present
            return not (cats[-1] == label_maps.IGNORE_LABEL and frac[-1] > RARE_MIN_FRAC)
        return False

    def _remap(self, labels: np.ndarray) -> np.ndarray:
        labels = np.asarray(labels)
        if labels.dtype == np.uint8 and len(self.lut) == 256:
            return native.remap_u8(labels, self.lut)  # the C op
        return label_maps.remap_labels(labels, self.lut)

    def __getitem__(self, index: int, rng: np.random.Generator | None = None) -> dict:
        image = _read_image(self.img_path(index))
        masks = [self.lbl_reader(self.lbl_path(index))]
        if self.pseudo_dir is not None:
            masks.append(Image.open(self.pseudo_path(index)))
        if self.resize_hw is not None:
            image, masks = resize_pair(image, masks, self.resize_hw)
        if self.transform is None:
            img_np = np.array(image)
            lbl_np = self._remap(np.array(masks[0]))
            rest = [np.array(m) for m in masks[1:]]
        else:
            rng = rng if rng is not None else np.random.default_rng()
            for _ in range(RARE_MAX_TRIES if self.rare_class_resample else 1):
                img_np, lbl_raw, *rest = self.transform(image, *masks, rng=rng)
                lbl_np = self._remap(lbl_raw)
                if not self.rare_class_resample or self._accept_rare(lbl_np):
                    break
        if img_np.dtype == np.uint8 and img_np.ndim == 3 and img_np.shape[-1] == 3:
            image_out = native.normalize_bgr(img_np, IMG_MEAN_BGR)  # the C op
        else:
            image_out = normalize_image(img_np)
        sample = {
            "image": image_out,
            "label": lbl_np.astype(np.uint8),
            "name": self.img_list[index],
        }
        if self.pseudo_dir is not None:
            # pseudo PNGs store trainIds (palette mode); out-of-range ids
            # become 255 (reference: CityLoader.py:130-132)
            sample["pseudo"] = label_maps.remap_labels(
                rest[0], label_maps.IDENTITY19_LUT).astype(np.uint8)
        return sample


def gta5_dataset(root: str, list_path: str, **kw) -> SegDataset:
    """GTA5: images/<name>, labels/<name>.  reference: GTA5Loader.py:54-56"""
    names = read_list(list_path)
    kw.setdefault("rare_class_resample", True)
    return SegDataset(root=root, img_list=names, lbl_list=names,
                      img_template="images/{name}", lbl_template="labels/{name}",
                      lut=label_maps.GTA5_LUT, **kw)


def synthia_dataset(root: str, list_path: str, **kw) -> SegDataset:
    """SYNTHIA: RGB/<name>, GT/LABELS/<name>.  reference: SYNTHIALoader.py:80-82"""
    names = read_list(list_path)
    kw.setdefault("rare_class_resample", True)
    return SegDataset(root=root, img_list=names, lbl_list=names,
                      img_template="RGB/{name}", lbl_template="GT/LABELS/{name}",
                      lut=label_maps.SYNTHIA_LUT, lbl_reader=read_synthia_label, **kw)


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
