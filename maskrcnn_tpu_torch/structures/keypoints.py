"""Keypoint targets of the data pipeline (host-side numpy).

Port copy of maskrcnn_tpu/structures/keypoints.py (after the reference
maskrcnn_benchmark/structures/keypoint.py): [N, K, 3] (x, y, visibility)
per instance, tied to an image size, following the BoxList through its
resize and horizontal flip. The heatmap targets are computed on the device
(models/roi_heads/keypoint_head.py:keypoints_to_heatmap).
"""

import numpy as np

from .boxlist import FLIP_LEFT_RIGHT


class Keypoints:
    def __init__(self, keypoints, size):
        keypoints = np.asarray(keypoints, np.float32)
        num = keypoints.shape[0]
        if num:
            keypoints = keypoints.reshape(num, -1, 3)
        else:
            keypoints = keypoints.reshape(0, 17, 3)
        self.keypoints = keypoints
        self.size = tuple(size)

    def crop(self, box):
        raise NotImplementedError("keypoints are not cropped (as in the reference)")

    def resize(self, size, *args, **kwargs):
        rw, rh = (float(s) / float(s_orig) for s, s_orig in zip(size, self.size))
        resized = self.keypoints.copy()
        resized[..., 0] *= rw
        resized[..., 1] *= rh
        return type(self)(resized, size)

    def transpose(self, method):
        """FLIP_LEFT_RIGHT: left and right joints swap (FLIP_INDS), x goes to
        width - x - 1, and invisible joints stay all zero."""
        if method != FLIP_LEFT_RIGHT:
            raise NotImplementedError("Only FLIP_LEFT_RIGHT implemented for keypoints")
        flipped = self.keypoints[:, type(self).FLIP_INDS]
        flipped[..., 0] = self.size[0] - flipped[..., 0] - 1
        flipped[flipped[..., 2] == 0] = 0
        return type(self)(flipped, self.size)

    def __getitem__(self, item):
        return type(self)(self.keypoints[item], self.size)

    def __len__(self):
        return self.keypoints.shape[0]

    def to_array(self):
        return self.keypoints

    def __repr__(self):
        return "{}(num_instances={}, size={})".format(type(self).__name__, len(self), self.size)


def _create_flip_indices(names, flip_map):
    full_flip_map = dict(flip_map)
    full_flip_map.update({v: k for k, v in flip_map.items()})
    flipped_names = [full_flip_map.get(i, i) for i in names]
    return np.array([names.index(i) for i in flipped_names], np.int64)


def kp_connections(keypoints):
    """The skeleton's joint pairs, by index into `keypoints` (the names)."""
    pairs = (
        ("left_eye", "right_eye"), ("left_eye", "nose"), ("right_eye", "nose"),
        ("right_eye", "right_ear"), ("left_eye", "left_ear"),
        ("right_shoulder", "right_elbow"), ("right_elbow", "right_wrist"),
        ("left_shoulder", "left_elbow"), ("left_elbow", "left_wrist"),
        ("right_hip", "right_knee"), ("right_knee", "right_ankle"),
        ("left_hip", "left_knee"), ("left_knee", "left_ankle"),
        ("right_shoulder", "left_shoulder"), ("right_hip", "left_hip"),
    )
    return [[keypoints.index(a), keypoints.index(b)] for a, b in pairs]


class PersonKeypoints(Keypoints):
    NAMES = [
        "nose", "left_eye", "right_eye", "left_ear", "right_ear",
        "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
        "left_wrist", "right_wrist", "left_hip", "right_hip",
        "left_knee", "right_knee", "left_ankle", "right_ankle",
    ]
    FLIP_MAP = {
        "left_eye": "right_eye",
        "left_ear": "right_ear",
        "left_shoulder": "right_shoulder",
        "left_elbow": "right_elbow",
        "left_wrist": "right_wrist",
        "left_hip": "right_hip",
        "left_knee": "right_knee",
        "left_ankle": "right_ankle",
    }


PersonKeypoints.FLIP_INDS = _create_flip_indices(PersonKeypoints.NAMES, PersonKeypoints.FLIP_MAP)
PersonKeypoints.CONNECTIONS = kp_connections(PersonKeypoints.NAMES)
