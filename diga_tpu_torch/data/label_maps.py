"""Label-id remapping tables and class names of the val datasets.

The port's own copy of ``diga_tpu/data/label_maps.py``: the val, GTA5
and SYNTHIA tables, the pseudo-label LUT and the palettes.

All tables are dense lookup tables (LUTs), so the remap is one vectorized
``np.take`` (reference: CityLoader.py:113-114, MapillaryLoader.py:39-131,
BDDLoader.py:120-137).  TrainId semantics match the Cityscapes 19-class
protocol; 255 is ignore.
"""

from __future__ import annotations

import numpy as np

IGNORE_LABEL = 255

# Cityscapes labelId -> trainId (19 classes).  reference: CityLoader.py:54-56
CITYSCAPES_ID_TO_TRAINID = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5,
    19: 6, 20: 7, 21: 8, 22: 9, 23: 10, 24: 11, 25: 12,
    26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}

# SYNTHIA labelId -> trainId (16 classes).
# reference: Synthia/util/loader/SYNTHIALoader.py:75-77
SYNTHIA_ID_TO_TRAINID = {
    3: 0, 4: 1, 2: 2, 21: 3, 5: 4, 7: 5,
    15: 6, 9: 7, 6: 8, 1: 9, 10: 10, 17: 11,
    8: 12, 19: 13, 12: 14, 11: 15,
}

# Mapillary Vistas (66 classes) -> Cityscapes trainId (19 classes).
# reference: domain_generalization/util/loader/MapillaryLoader.py:39-131
MAPILLARY_ID_TO_TRAINID = {
    13: 0, 24: 0, 41: 0,          # road, lane marking, manhole
    2: 1, 15: 1,                   # curb, sidewalk
    17: 2,                         # building
    6: 3,                          # wall
    3: 4,                          # fence
    45: 5, 47: 5,                  # pole, utility pole
    48: 6,                         # traffic light
    50: 7,                         # traffic sign
    30: 8,                         # vegetation
    29: 9,                         # terrain
    27: 10,                        # sky
    19: 11,                        # person
    20: 12, 21: 12, 22: 12,        # bicyclist, motorcyclist, other rider
    55: 13,                        # car
    61: 14,                        # truck
    54: 15,                        # bus
    58: 16,                        # on rails
    57: 17,                        # motorcycle
    52: 18,                        # bicycle
}

# 19-class Cityscapes palette (RGB).  reference: CityLoader.py:9-27
CITYSCAPES_COLORS_19 = np.array(
    [
        [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
        [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
        [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
        [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100],
        [0, 80, 100], [0, 0, 230], [119, 11, 32],
    ],
    dtype=np.uint8,
)

# 16-class SYNTHIA palette (RGB).  reference: SYNTHIALoader.py:24-53
SYNTHIA_COLORS_16 = np.array(
    [
        [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
        [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
        [107, 142, 35], [70, 130, 180], [220, 20, 60], [255, 0, 0],
        [0, 0, 142], [0, 60, 100], [0, 0, 230], [119, 11, 32],
    ],
    dtype=np.uint8,
)

CLASS_NAMES_19 = [
    "road", "sidewalk", "building", "wall", "fence", "pole", "light",
    "sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
]

CLASS_NAMES_16 = [
    "road", "sidewalk", "building", "wall", "fence", "pole", "light",
    "sign", "vegetation", "sky", "person", "rider", "car", "bus",
    "motorcycle", "bicycle",
]


def build_lut(mapping: dict[int, int], size: int = 256, fill: int = IGNORE_LABEL) -> np.ndarray:
    """Dense LUT for labelId -> trainId remapping; unmapped ids -> ``fill``."""
    lut = np.full((size,), fill, dtype=np.uint8)
    for k, v in mapping.items():
        lut[k] = v
    return lut


CITYSCAPES_LUT = build_lut(CITYSCAPES_ID_TO_TRAINID)
GTA5_LUT = CITYSCAPES_LUT
SYNTHIA_LUT = build_lut(SYNTHIA_ID_TO_TRAINID)
MAPILLARY_LUT = build_lut(MAPILLARY_ID_TO_TRAINID)
# BDD100k labels already come as trainIds: 0..18 kept, everything else
# ignored.  reference: BDDLoader.py:120-125
BDD_LUT = build_lut({i: i for i in range(19)})
# Pseudo-label PNGs round-trip through the palette format and are already
# trainIds.  reference: CityLoader.py:130-132
IDENTITY19_LUT = BDD_LUT


def remap_labels(labels: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Remap raw label ids to trainIds with a dense LUT (vectorized)."""
    ids = np.asarray(labels)
    clipped = np.minimum(ids, len(lut) - 1).astype(np.int64)
    return lut[clipped]


def make_png_palette(colors: np.ndarray) -> list[int]:
    """Flat 768-entry PNG palette from an (N, 3) RGB color table (the
    reference's pseudo-label palette, pseudolabel_generator.py:38-43)."""
    flat = list(np.asarray(colors, dtype=np.uint8).reshape(-1))
    flat += [0] * (256 * 3 - len(flat))
    return [int(x) for x in flat]


def decode_segmap(label_img: np.ndarray, colors: np.ndarray = CITYSCAPES_COLORS_19) -> np.ndarray:
    """TrainId map -> float RGB in [0, 1], (H, W) or (B, H, W); ids past the
    colour table keep the reference's id/255 grey, so ignore (255) renders
    white (reference CityLoader.decode_segmap, :140-157)."""
    ids = np.asarray(label_img).astype(np.int64)
    table = np.zeros((256, 3), dtype=np.float64)
    table[: len(colors)] = np.asarray(colors, dtype=np.float64) / 255.0
    table[len(colors):] = (np.arange(len(colors), 256, dtype=np.float64) / 255.0)[:, None]
    return table[np.clip(ids, 0, 255)]
