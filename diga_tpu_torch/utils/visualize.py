"""Image-grid visualization artifacts.

The port's own copy of ``diga_tpu/utils/visualize.py``: the reference
dumps JPEG grids of its train views every 500 iterations
(train_DiGA_gta2city_warm_up.py:326-341); here the grid is assembled with
numpy (no torchvision), and the loop writes it only every ``viz_every``
steps.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from ..data.label_maps import CITYSCAPES_COLORS_19, decode_segmap
from ..data.normalize import IMG_MEAN_BGR


def image_unit_rgb(img_norm: np.ndarray) -> np.ndarray:
    """Model-space BGR NHWC -> [0, 1] RGB for display."""
    bgr = np.asarray(img_norm) * 128.0 + IMG_MEAN_BGR
    return np.clip(bgr[..., ::-1] / 255.0, 0.0, 1.0)


def label_rgb(labels: np.ndarray, colors=CITYSCAPES_COLORS_19) -> np.ndarray:
    return decode_segmap(np.asarray(labels), colors)


def make_grid(rows: list[np.ndarray], pad: int = 2) -> np.ndarray:
    """``rows``: (B, H, W, 3) float arrays in [0, 1]; one image with each
    row laid out horizontally (the reference's make_grid with nrow=batch)."""
    row_imgs = []
    for r in rows:
        r = np.asarray(r)
        b, h, w, _ = r.shape
        padded = np.ones((h + 2 * pad, b * (w + 2 * pad), 3), np.float64)
        for i in range(b):
            padded[pad:pad + h, i * (w + 2 * pad) + pad: i * (w + 2 * pad) + pad + w] = r[i]
        row_imgs.append(padded)
    width = max(r.shape[1] for r in row_imgs)
    return np.concatenate([np.pad(r, ((0, 0), (0, width - r.shape[1]), (0, 0)),
                                  constant_values=1.0) for r in row_imgs], axis=0)


def save_grid(path: str, rows: list[np.ndarray]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    grid = make_grid(rows)
    Image.fromarray(np.clip(grid * 255, 0, 255).astype(np.uint8)).save(path)


def dump_train_views(out_dir: str, step: int, images: dict[str, np.ndarray],
                     labels: dict[str, np.ndarray], colors=CITYSCAPES_COLORS_19) -> None:
    """Write ``<step>_views.jpg``: a row per image batch, then a row per
    label batch (reference :332-341)."""
    rows = [image_unit_rgb(v) for v in images.values()]
    rows += [label_rgb(v, colors) for v in labels.values()]
    save_grid(os.path.join(out_dir, f"{step:05d}_views.jpg"), rows)
