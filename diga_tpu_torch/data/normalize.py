"""Input normalization protocol.

The port's own copy of ``diga_tpu/data/normalize.py``.  The DiGA protocol
feeds models BGR images, mean-subtracted and divided by 128 (reference:
CityLoader.py:104-107, IMG_MEAN at train_DiGA_gta2city_warm_up.py:73).
Images stay NHWC on the host, the layout of the JAX package.
"""

from __future__ import annotations

import numpy as np

# BGR order; reference: train_DiGA_gta2city_warm_up.py:73
IMG_MEAN_BGR = np.array((104.00698793, 116.66876762, 122.67891434), dtype=np.float32)


def normalize_image(rgb_uint8: np.ndarray, mean_bgr: np.ndarray = IMG_MEAN_BGR) -> np.ndarray:
    """uint8 RGB HWC -> float32 BGR HWC, mean-subtracted, /128."""
    img = np.asarray(rgb_uint8, dtype=np.float32)
    img = img[..., ::-1]  # RGB -> BGR
    img = img - mean_bgr
    return img / 128.0


def denormalize_image(bgr_norm: np.ndarray, mean_bgr: np.ndarray = IMG_MEAN_BGR) -> np.ndarray:
    """float32 BGR HWC normalized -> uint8 RGB HWC (clipped, truncated)."""
    img = np.asarray(bgr_norm, dtype=np.float32) * 128.0 + mean_bgr
    img = img[..., ::-1]
    return np.clip(img, 0, 255).astype(np.uint8)
