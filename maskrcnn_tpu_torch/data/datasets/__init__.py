from .coco import COCODataset

__all__ = ["COCODataset"]
