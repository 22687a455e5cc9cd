from .boxlist import FLIP_LEFT_RIGHT, FLIP_TOP_BOTTOM, BoxList
from .keypoints import Keypoints, PersonKeypoints
from .segmentation_mask import SegmentationMask

__all__ = ["BoxList", "FLIP_LEFT_RIGHT", "FLIP_TOP_BOTTOM", "Keypoints", "PersonKeypoints",
           "SegmentationMask"]
