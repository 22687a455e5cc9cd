"""BoxList: the host-side box container of the data pipeline.

Port copy of maskrcnn_tpu/structures/boxlist.py (after the reference
maskrcnn_benchmark/structures/bounding_box.py): Nx4 boxes on numpy tied to
an image size, with a dict of per-box fields that follow every geometric
operation. The model never sees it: the collator turns targets into padded
arrays. Modes "xyxy" and "xywh", +1 pixel convention as in the reference.
"""

import numpy as np

FLIP_LEFT_RIGHT = 0
FLIP_TOP_BOTTOM = 1

TO_REMOVE = 1


class BoxList:
    def __init__(self, bbox, image_size, mode="xyxy"):
        bbox = np.asarray(bbox, dtype=np.float32)
        if bbox.ndim != 2 and not (bbox.ndim == 1 and bbox.size == 0):
            raise ValueError(
                "bbox should have 2 dimensions, got {}".format(bbox.ndim)
            )
        if bbox.size == 0:
            bbox = bbox.reshape(0, 4)
        if bbox.shape[-1] != 4:
            raise ValueError(
                "last dimension of bbox should be 4, got {}".format(bbox.shape[-1])
            )
        if mode not in ("xyxy", "xywh"):
            raise ValueError("mode should be 'xyxy' or 'xywh'")
        self.bbox = bbox
        self.size = tuple(image_size)  # (image_width, image_height)
        self.mode = mode
        self.extra_fields = {}

    # -- fields --------------------------------------------------------------
    def add_field(self, field, field_data):
        self.extra_fields[field] = field_data

    def get_field(self, field):
        return self.extra_fields[field]

    def has_field(self, field):
        return field in self.extra_fields

    def fields(self):
        return list(self.extra_fields.keys())

    def _copy_extra_fields(self, other):
        for k, v in other.extra_fields.items():
            self.extra_fields[k] = v

    # -- conversions -----------------------------------------------------------
    def convert(self, mode):
        if mode == self.mode:
            return self
        xmin, ymin, xmax, ymax = self._split_into_xyxy()
        if mode == "xyxy":
            bbox = np.concatenate((xmin, ymin, xmax, ymax), axis=-1)
        else:
            bbox = np.concatenate(
                (xmin, ymin, xmax - xmin + TO_REMOVE, ymax - ymin + TO_REMOVE),
                axis=-1,
            )
        out = BoxList(bbox, self.size, mode=mode)
        out._copy_extra_fields(self)
        return out

    def _split_into_xyxy(self):
        if self.mode == "xyxy":
            xmin, ymin, xmax, ymax = np.split(self.bbox, 4, axis=-1)
            return xmin, ymin, xmax, ymax
        xmin, ymin, w, h = np.split(self.bbox, 4, axis=-1)
        return (
            xmin,
            ymin,
            xmin + np.clip(w - TO_REMOVE, 0, None),
            ymin + np.clip(h - TO_REMOVE, 0, None),
        )

    # -- geometry --------------------------------------------------------------
    def resize(self, size, *args, **kwargs):
        """size: (width, height)."""
        ratios = tuple(float(s) / float(s_orig) for s, s_orig in zip(size, self.size))
        if ratios[0] == ratios[1]:
            bbox = self.bbox * ratios[0]
        else:
            rw, rh = ratios
            xmin, ymin, xmax, ymax = self._split_into_xyxy()
            bbox = np.concatenate(
                (xmin * rw, ymin * rh, xmax * rw, ymax * rh), axis=-1
            )
            out = BoxList(bbox, size, mode="xyxy")
            for k, v in self.extra_fields.items():
                if not isinstance(v, np.ndarray):
                    v = v.resize(size, *args, **kwargs)
                out.add_field(k, v)
            return out.convert(self.mode)
        out = BoxList(bbox, size, mode=self.mode)
        for k, v in self.extra_fields.items():
            if not isinstance(v, np.ndarray):
                v = v.resize(size, *args, **kwargs)
            out.add_field(k, v)
        return out

    def transpose(self, method):
        if method not in (FLIP_LEFT_RIGHT, FLIP_TOP_BOTTOM):
            raise NotImplementedError(
                "Only FLIP_LEFT_RIGHT and FLIP_TOP_BOTTOM implemented"
            )
        image_width, image_height = self.size
        xmin, ymin, xmax, ymax = self._split_into_xyxy()
        if method == FLIP_LEFT_RIGHT:
            tr_xmin = image_width - xmax - TO_REMOVE
            tr_xmax = image_width - xmin - TO_REMOVE
            tr_ymin, tr_ymax = ymin, ymax
        else:
            tr_xmin, tr_xmax = xmin, xmax
            tr_ymin = image_height - ymax - TO_REMOVE
            tr_ymax = image_height - ymin - TO_REMOVE
        bbox = np.concatenate((tr_xmin, tr_ymin, tr_xmax, tr_ymax), axis=-1)
        out = BoxList(bbox, self.size, mode="xyxy")
        for k, v in self.extra_fields.items():
            if not isinstance(v, np.ndarray):
                v = v.transpose(method)
            out.add_field(k, v)
        return out.convert(self.mode)

    def crop(self, box):
        """Crop to region `box` (x1, y1, x2, y2)."""
        xmin, ymin, xmax, ymax = self._split_into_xyxy()
        w, h = box[2] - box[0], box[3] - box[1]
        cropped_xmin = np.clip(xmin - box[0], 0, w)
        cropped_ymin = np.clip(ymin - box[1], 0, h)
        cropped_xmax = np.clip(xmax - box[0], 0, w)
        cropped_ymax = np.clip(ymax - box[1], 0, h)
        bbox = np.concatenate(
            (cropped_xmin, cropped_ymin, cropped_xmax, cropped_ymax), axis=-1
        )
        out = BoxList(bbox, (w, h), mode="xyxy")
        for k, v in self.extra_fields.items():
            if not isinstance(v, np.ndarray):
                v = v.crop(box)
            out.add_field(k, v)
        return out.convert(self.mode)

    def clip_to_image(self, remove_empty=True):
        self.bbox[:, 0] = np.clip(self.bbox[:, 0], 0, self.size[0] - TO_REMOVE)
        self.bbox[:, 1] = np.clip(self.bbox[:, 1], 0, self.size[1] - TO_REMOVE)
        self.bbox[:, 2] = np.clip(self.bbox[:, 2], 0, self.size[0] - TO_REMOVE)
        self.bbox[:, 3] = np.clip(self.bbox[:, 3], 0, self.size[1] - TO_REMOVE)
        if remove_empty:
            box = self.bbox
            keep = (box[:, 3] > box[:, 1]) & (box[:, 2] > box[:, 0])
            return self[keep]
        return self

    def area(self):
        box = self.bbox
        if self.mode == "xyxy":
            return (box[:, 2] - box[:, 0] + TO_REMOVE) * (box[:, 3] - box[:, 1] + TO_REMOVE)
        return box[:, 2] * box[:, 3]

    # -- indexing ---------------------------------------------------------------
    def __getitem__(self, item):
        out = BoxList(self.bbox[item].reshape(-1, 4), self.size, self.mode)
        for k, v in self.extra_fields.items():
            out.add_field(k, v[item])
        return out

    def __len__(self):
        return self.bbox.shape[0]

    def __repr__(self):
        return (
            "BoxList(num_boxes={}, image_width={}, image_height={}, mode={})"
        ).format(len(self), self.size[0], self.size[1], self.mode)
