"""Host-side paired geometric augmentations (numpy/PIL).

The port's own copy of ``diga_tpu/data/transforms.py`` (:33-132): image
resampled bilinearly, masks nearest, any number of masks, each random
draw from an explicit numpy ``Generator`` (reference:
util/loader/augmentations.py:10-221).  Photometric augmentation runs on
the device in ``ops/photometric.py``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from PIL import Image


def _to_pil_img(img: np.ndarray) -> Image.Image:
    return Image.fromarray(np.asarray(img, dtype=np.uint8))


def _to_pil_mask(mask: np.ndarray) -> Image.Image:
    arr = np.asarray(mask)
    if arr.dtype == np.uint8:
        return Image.fromarray(arr, mode="L")
    return Image.fromarray(arr.astype(np.int32), mode="I")


def resize_pair(
    img: Image.Image, masks: Sequence[Image.Image], size_hw: tuple[int, int]
) -> tuple[Image.Image, list[Image.Image]]:
    """Resize to (h, w): image BICUBIC, masks NEAREST.

    Matches the loaders' pre-transform resize (reference:
    CityLoader.py:91-95, GTA5Loader.py:77-79).
    """
    h, w = size_hw
    img = img.resize((w, h), Image.BICUBIC)
    masks = [m.resize((w, h), Image.NEAREST) for m in masks]
    return img, masks


class Compose:
    """Run paired transforms; returns the numpy image and uint8 masks
    (reference ``Compose``/``Compose_Pseudo``, augmentations.py:10-31)."""

    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img, *masks, rng: np.random.Generator):
        if isinstance(img, np.ndarray):
            img = _to_pil_img(img)
        masks = [_to_pil_mask(m) if isinstance(m, np.ndarray) else m for m in masks]
        for t in self.transforms:
            img, masks = t(img, masks, rng)
        out_masks = [np.array(m, dtype=np.uint8) for m in masks]
        return (np.array(img), *out_masks)


class RandomHorizontallyFlip:
    """p=0.5 joint horizontal flip (reference: augmentations.py:105-116)."""

    def __call__(self, img, masks, rng):
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            masks = [m.transpose(Image.FLIP_LEFT_RIGHT) for m in masks]
        return img, masks


class RandomCrop:
    """Random (th, tw) crop; bilinear/nearest up-resize if the input is
    smaller (reference: augmentations.py:34-57)."""

    def __init__(self, size):
        self.size = (int(size), int(size)) if isinstance(size, (int, float)) else tuple(size)

    def __call__(self, img, masks, rng):
        w, h = img.size
        th, tw = self.size
        if w == tw and h == th:
            return img, masks
        if w < tw or h < th:
            img = img.resize((tw, th), Image.BILINEAR)
            masks = [m.resize((tw, th), Image.NEAREST) for m in masks]
            return img, masks
        x1 = int(rng.integers(0, w - tw + 1))
        y1 = int(rng.integers(0, h - th + 1))
        box = (x1, y1, x1 + tw, y1 + th)
        return img.crop(box), [m.crop(box) for m in masks]


class RandomSizedAndCrop:
    """Uniform(0.7, 1.0) independent w/h downscale, then RandomCrop
    (reference: augmentations.py:190-221)."""

    def __init__(self, size):
        self.crop = RandomCrop(size)

    def __call__(self, img, masks, rng):
        w = int(rng.uniform(0.7, 1.0) * img.size[0])
        h = int(rng.uniform(0.7, 1.0) * img.size[1])
        img = img.resize((w, h), Image.BILINEAR)
        masks = [m.resize((w, h), Image.NEAREST) for m in masks]
        return self.crop(img, masks, rng)


class CenterCrop:
    """Deterministic center crop (reference: augmentations.py:89-102)."""

    def __init__(self, size):
        self.size = (int(size), int(size)) if isinstance(size, (int, float)) else tuple(size)

    def __call__(self, img, masks, rng):
        w, h = img.size
        th, tw = self.size
        x1 = int(round((w - tw) / 2.0))
        y1 = int(round((h - th) / 2.0))
        box = (x1, y1, x1 + tw, y1 + th)
        return img.crop(box), [m.crop(box) for m in masks]
