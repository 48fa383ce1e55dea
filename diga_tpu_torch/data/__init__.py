from . import label_maps, synthetic
from .datasets import (
    SegDataset,
    bdd_dataset,
    cityscapes_dataset,
    mapillary_dataset,
    read_list,
)
from .normalize import IMG_MEAN_BGR, normalize_image
