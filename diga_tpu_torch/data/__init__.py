from . import label_maps, synthetic
from .datasets import (
    SegDataset,
    bdd_dataset,
    cityscapes_dataset,
    gta5_dataset,
    mapillary_dataset,
    read_list,
    read_synthia_label,
    synthia_dataset,
)
from .normalize import IMG_MEAN_BGR, normalize_image
from .transforms import Compose, RandomCrop, RandomHorizontallyFlip, RandomSizedAndCrop
