"""Host-side paired resize (numpy/PIL).

The port's own copy of ``resize_pair`` from ``diga_tpu/data/transforms.py``,
the one transform the val loaders use (the training-time crops and flips
come with the training slice).
"""

from __future__ import annotations

from typing import Sequence

from PIL import Image


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
