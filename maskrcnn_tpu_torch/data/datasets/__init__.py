from .cityscapes import CityScapesDataset
from .coco import COCODataset
from .concat import AbstractDataset, ConcatDataset, ListDataset
from .voc import PascalVOCDataset

__all__ = [
    "COCODataset",
    "CityScapesDataset",
    "ConcatDataset",
    "ListDataset",
    "AbstractDataset",
    "PascalVOCDataset",
]
