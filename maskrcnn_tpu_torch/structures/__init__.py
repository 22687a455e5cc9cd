from .boxlist import FLIP_LEFT_RIGHT, FLIP_TOP_BOTTOM, BoxList
from .segmentation_mask import SegmentationMask

__all__ = ["BoxList", "FLIP_LEFT_RIGHT", "FLIP_TOP_BOTTOM", "SegmentationMask"]
