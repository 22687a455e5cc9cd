"""Instance masks of the data pipeline: polygons and binary masks.

Port copy of maskrcnn_tpu/structures/segmentation_mask.py (after the
reference maskrcnn_benchmark/structures/segmentation_mask.py). Two
backings, one API:
  * PolygonList: per-instance COCO polygon lists whose crop, resize and
    flip stay in polygon space; rasterization (``get_mask_tensor``) happens
    on demand through the native scanline fill of ``utils/maskops.py``;
  * BinaryMaskList: dense [N, H, W] masks (Cityscapes' instance-id images).
    Its resize is OpenCV's INTER_NEAREST computed with numpy, bit for bit:
    output pixel i takes source pixel floor(i * (1 / (dst / src))) in
    float64, clamped to the last one, as cv2.resize does.

``SegmentationMask.convert("mask")`` rasterizes polygons; ``convert("poly")``
traces each binary mask's outer contours (``BinaryMaskList.convert_to_polygon``:
OpenCV's findContours(RETR_EXTERNAL, CHAIN_APPROX_TC89_L1) in the JAX
package, the native ``utils/maskops.py:trace_contours`` here, without
OpenCV).
"""

import numpy as np

from .boxlist import FLIP_LEFT_RIGHT


def rasterize_polygons(polygons, height, width):
    """Rasterize a list of flat [x0,y0,x1,y1,...] polygons to a uint8 mask."""
    from ..utils.maskops import polygons_to_mask

    return polygons_to_mask(polygons, height, width)


class PolygonInstance:
    """One object instance = a list of polygons (holes unsupported, as in
    COCO instance annotations)."""

    def __init__(self, polygons, size):
        if isinstance(polygons, PolygonInstance):
            polygons = [p.copy() for p in polygons.polygons]
        else:
            polygons = [np.asarray(p, dtype=np.float64).reshape(-1) for p in polygons]
        self.polygons = polygons
        self.size = tuple(size)  # (w, h)

    def transpose(self, method):
        w, h = self.size
        flipped = []
        for poly in self.polygons:
            p = poly.copy()
            if method == FLIP_LEFT_RIGHT:
                p[0::2] = w - poly[0::2] - 1
            else:
                p[1::2] = h - poly[1::2] - 1
            flipped.append(p)
        return PolygonInstance(flipped, self.size)

    def crop(self, box):
        x1, y1, x2, y2 = map(float, box)
        w = max(x2 - x1, 1.0)
        h = max(y2 - y1, 1.0)
        cropped = []
        for poly in self.polygons:
            p = poly.copy()
            p[0::2] = np.clip(poly[0::2] - x1, 0, w)
            p[1::2] = np.clip(poly[1::2] - y1, 0, h)
            cropped.append(p)
        return PolygonInstance(cropped, (w, h))

    def resize(self, size):
        rw = float(size[0]) / max(self.size[0], 1e-8)
        rh = float(size[1]) / max(self.size[1], 1e-8)
        scaled = []
        for poly in self.polygons:
            p = poly.copy()
            p[0::2] = poly[0::2] * rw
            p[1::2] = poly[1::2] * rh
            scaled.append(p)
        return PolygonInstance(scaled, size)

    def get_mask_tensor(self):
        w, h = int(round(self.size[0])), int(round(self.size[1]))
        return rasterize_polygons(self.polygons, h, w)

    def __repr__(self):
        return "PolygonInstance(num_polygons={}, size={})".format(
            len(self.polygons), self.size
        )


class PolygonList:
    def __init__(self, polygons, size):
        if isinstance(polygons, PolygonList):
            polygons = [PolygonInstance(p, size) for p in polygons.polygons]
        else:
            polygons = [
                p if isinstance(p, PolygonInstance) else PolygonInstance(p, size)
                for p in polygons
            ]
        self.polygons = polygons
        self.size = tuple(size)

    def transpose(self, method):
        return PolygonList([p.transpose(method) for p in self.polygons], self.size)

    def crop(self, box):
        w = box[2] - box[0]
        h = box[3] - box[1]
        return PolygonList([p.crop(box) for p in self.polygons], (w, h))

    def resize(self, size):
        return PolygonList([p.resize(size) for p in self.polygons], size)

    def get_mask_tensor(self):
        if len(self.polygons) == 0:
            w, h = int(self.size[0]), int(self.size[1])
            return np.zeros((0, h, w), dtype=np.uint8)
        return np.stack([p.get_mask_tensor() for p in self.polygons])

    def __len__(self):
        return len(self.polygons)

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            selected = [self.polygons[int(item)]]
        elif isinstance(item, slice):
            selected = self.polygons[item]
        else:
            item = np.asarray(item)
            if item.dtype == bool:
                item = np.nonzero(item)[0]
            selected = [self.polygons[int(i)] for i in item]
        return PolygonList(selected, self.size)

    def __repr__(self):
        return "PolygonList(num_instances={}, size={})".format(
            len(self.polygons), self.size
        )


def nearest_indices(src, dst):
    """The source index of each of `dst` outputs along an axis of `src`
    pixels under cv2.resize's INTER_NEAREST."""
    ifx = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * ifx).astype(np.int64), src - 1)


class BinaryMaskList:
    def __init__(self, masks, size):
        """masks: [N, H, W] array (uint8/bool)."""
        self.masks = np.asarray(masks)
        if self.masks.ndim == 2:
            self.masks = self.masks[None]
        self.size = tuple(size)

    def transpose(self, method):
        axis = 2 if method == FLIP_LEFT_RIGHT else 1
        return BinaryMaskList(np.flip(self.masks, axis=axis).copy(), self.size)

    def crop(self, box):
        x1, y1, x2, y2 = (int(round(b)) for b in box)
        w = max(x2 - x1, 1)
        h = max(y2 - y1, 1)
        x1 = max(x1, 0)
        y1 = max(y1, 0)
        cropped = self.masks[:, y1:y1 + h, x1:x1 + w]
        pad_h = h - cropped.shape[1]
        pad_w = w - cropped.shape[2]
        if pad_h > 0 or pad_w > 0:
            cropped = np.pad(cropped, ((0, 0), (0, max(pad_h, 0)), (0, max(pad_w, 0))))
        return BinaryMaskList(cropped, (w, h))

    def resize(self, size):
        w, h = int(size[0]), int(size[1])
        if len(self.masks) == 0:
            return BinaryMaskList(np.zeros((0, h, w), np.uint8), (w, h))
        masks = self.masks.view(np.uint8) if self.masks.dtype == bool else self.masks
        rows = masks.astype(np.uint8, copy=False)[:, nearest_indices(masks.shape[1], h)]
        return BinaryMaskList(rows[:, :, nearest_indices(masks.shape[2], w)], (w, h))

    def get_mask_tensor(self):
        return self.masks

    def convert_to_polygon(self):
        """Each instance's outer contours as flat float64 [x0, y0, x1, y1, ...]
        rings in OpenCV's order (JAX segmentation_mask.py:convert_to_polygon);
        contours of fewer than 3 points are dropped."""
        from ..utils.maskops import trace_contours

        if self.masks.size == 0:
            return PolygonList([], self.size)
        instances = [[c.reshape(-1).astype(np.float64).tolist()
                      for c in trace_contours(m) if c.shape[0] >= 3] for m in self.masks]
        return PolygonList(instances, self.size)

    def __len__(self):
        return self.masks.shape[0]

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            return BinaryMaskList(self.masks[int(item)][None], self.size)
        return BinaryMaskList(self.masks[item], self.size)

    def __repr__(self):
        return "BinaryMaskList(num_instances={}, size={})".format(len(self), self.size)


class SegmentationMask:
    """The instances of one image: PolygonList ("poly") or BinaryMaskList
    ("mask")."""

    def __init__(self, instances, size, mode="poly"):
        if mode == "poly":
            self.instances = (
                instances if isinstance(instances, PolygonList) else PolygonList(instances, size))
        elif mode == "mask":
            self.instances = (
                instances if isinstance(instances, BinaryMaskList)
                else BinaryMaskList(instances, size))
        else:
            raise ValueError("SegmentationMask mode {!r}".format(mode))
        self.mode = mode
        self.size = tuple(size)

    def transpose(self, method):
        return SegmentationMask(self.instances.transpose(method), self.size, self.mode)

    def crop(self, box):
        cropped = self.instances.crop(box)
        return SegmentationMask(cropped, cropped.size, self.mode)

    def resize(self, size):
        return SegmentationMask(self.instances.resize(size), size, self.mode)

    def convert(self, mode):
        if mode == self.mode:
            return self
        if mode == "mask":
            return SegmentationMask(
                BinaryMaskList(self.instances.get_mask_tensor(), self.size), self.size, "mask")
        if mode == "poly":
            return SegmentationMask(self.instances.convert_to_polygon(), self.size, "poly")
        raise ValueError("SegmentationMask mode {!r}".format(mode))

    def get_mask_tensor(self):
        t = self.instances.get_mask_tensor()
        return t.squeeze(0) if t.shape[0] == 1 else t

    def __len__(self):
        return len(self.instances)

    def __getitem__(self, item):
        return SegmentationMask(self.instances[item], self.size, self.mode)

    def __repr__(self):
        return "SegmentationMask(num_instances={}, mode={}, size={})".format(
            len(self), self.mode, self.size)
