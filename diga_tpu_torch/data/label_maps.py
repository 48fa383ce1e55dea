"""Label-id remapping tables and class names of the val datasets.

The port's own copy of the evaluation part of ``diga_tpu/data/label_maps.py``
(the GTA5/SYNTHIA tables and the palettes come with the training and
pseudo-label slices).

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
MAPILLARY_LUT = build_lut(MAPILLARY_ID_TO_TRAINID)
# BDD100k labels already come as trainIds: 0..18 kept, everything else
# ignored.  reference: BDDLoader.py:120-125
BDD_LUT = build_lut({i: i for i in range(19)})


def remap_labels(labels: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Remap raw label ids to trainIds with a dense LUT (vectorized)."""
    ids = np.asarray(labels)
    clipped = np.minimum(ids, len(lut) - 1).astype(np.int64)
    return lut[clipped]
