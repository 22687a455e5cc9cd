"""Native Cityscapes instance-segmentation dataset (gtFine layout).

Port copy of maskrcnn_tpu/data/datasets/cityscapes.py (after the reference
maskrcnn_benchmark/data/datasets/cityscapes.py:19-236): the official
leftImg8bit/gtFine trees read directly, either the ``*_polygons.json``
annotations ("poly" mode) or the ``*_instanceIds.png`` label images ("mask"
mode, binary masks), with no cityscapesscripts dependency (the
instance-class table below is the only fact needed from it). ``min_area``
drops instances of a smaller box area, ``mini`` keeps about that many
images, and an image without instances is replaced by the next one that
has some (its index still reported).

Images are HWC uint8 RGB numpy arrays. The frame and the instance-id image
are decoded with Pillow in ``_load_image`` and ``_load_instance_ids`` only:
override them to hand both over in memory.

Class universe: every Cityscapes label with hasInstances=True, in the
official label-table order, after __background__ (the reference's
``[l.name for l in csHelpers.labels if l.hasInstances]``).
"""

import glob
import json
import os

import numpy as np

from ...structures.boxlist import BoxList
from ...structures.segmentation_mask import SegmentationMask
from .concat import AbstractDataset

# (name, cityscapes label id) for labels with hasInstances=True, in the
# official cityscapesscripts label-table order
_INSTANCE_LABELS = (
    ("person", 24),
    ("rider", 25),
    ("car", 26),
    ("truck", 27),
    ("bus", 28),
    ("caravan", 29),
    ("trailer", 30),
    ("train", 31),
    ("motorcycle", 32),
    ("bicycle", 33),
)


class CityScapesDataset(AbstractDataset):
    CLASSES = ("__background__",) + tuple(n for n, _ in _INSTANCE_LABELS)

    def __init__(self, img_dir, ann_dir, split, mode="mask", transforms=None, min_area=0,
                 mini=None):
        """img_dir: .../leftImg8bit; ann_dir: .../gtFine; split in
        train/val/test; mode "poly" or "mask"; min_area drops instances with
        smaller bbox area; mini subsamples the dataset to ~mini items."""
        if split not in ("train", "val", "test"):
            raise ValueError("Cityscapes split {!r}".format(split))
        if mode not in ("poly", "mask"):
            raise ValueError("Cityscapes mode {!r}".format(mode))
        img_dir = os.path.abspath(os.path.join(img_dir, split))
        ann_dir = os.path.abspath(os.path.join(ann_dir, split))
        for d in (img_dir, ann_dir):
            if not os.path.exists(d):
                raise FileNotFoundError(d)

        self.split = split
        self.mode = mode
        self.ann_dir = ann_dir
        self.transforms = transforms
        self.min_area = int(min_area)

        self.name_to_id = {n: i for i, n in enumerate(self.CLASSES)}
        self.id_to_name = dict(enumerate(self.CLASSES))
        self.cityscapesID_to_ind = {cid: self.name_to_id[name] for name, cid in _INSTANCE_LABELS}

        suffix = "*_instanceIds.png" if mode == "mask" else "*_polygons.json"
        img_paths = sorted(glob.glob(os.path.join(img_dir, "*", "*_leftImg8bit.png")))
        ann_paths = sorted(glob.glob(os.path.join(ann_dir, "*", suffix)))
        # alignment is checked before the mini subsampling: unequal glob
        # counts can stride down to equal lengths while pairing every image
        # with the wrong annotation
        if len(img_paths) != len(ann_paths):
            raise ValueError("{} images but {} annotations".format(len(img_paths),
                                                                   len(ann_paths)))
        if mini is not None:
            stride = len(img_paths) // mini + 1
            img_paths = img_paths[::stride]
            ann_paths = ann_paths[::stride]
        self.img_paths = img_paths
        self.ann_paths = ann_paths

    def __len__(self):
        return len(self.img_paths)

    # -- files -------------------------------------------------------------

    def _load_image(self, idx):
        from PIL import Image

        with Image.open(self.img_paths[idx]) as im:
            return np.array(im.convert("RGB"))

    def _load_instance_ids(self, idx):
        from PIL import Image

        with Image.open(self.ann_paths[idx]) as im:
            return np.asarray(im)

    # -- annotation parsing ------------------------------------------------

    def _parse_polygons(self, ann):
        boxes, segs, labels = [], [], []
        for obj in ann["objects"]:
            name = obj["label"]
            if name not in self.name_to_id:
                continue  # drops e.g. "*group" and non-instance classes
            flat = [float(v) for xy in obj["polygon"] for v in xy]
            xs, ys = flat[0::2], flat[1::2]
            boxes.append((int(min(xs)), int(min(ys)), int(max(xs)), int(max(ys))))
            segs.append([flat])
            labels.append(self.name_to_id[name])
        return boxes, segs, labels

    def _parse_instance_ids(self, ids):
        boxes, segs, labels = [], [], []
        for inst_id in np.unique(ids):
            if inst_id < 1000:
                continue  # semantic or group label, not an instance
            mask = ids == inst_id
            ys, xs = np.nonzero(mask)
            boxes.append((int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())))
            segs.append(mask)
            labels.append(self.cityscapesID_to_ind[int(inst_id) // 1000])
        return boxes, segs, labels

    def _load_anno(self, idx):
        if self.mode == "poly":
            with open(self.ann_paths[idx]) as f:
                boxes, segs, labels = self._parse_polygons(json.load(f))
        else:
            boxes, segs, labels = self._parse_instance_ids(self._load_instance_ids(idx))
        if self.min_area > 0:
            kept = [i for i, (x0, y0, x1, y1) in enumerate(boxes)
                    if (x1 - x0) * (y1 - y0) >= self.min_area]
            boxes = [boxes[i] for i in kept]
            segs = [segs[i] for i in kept]
            labels = [labels[i] for i in kept]
        return boxes, segs, labels

    # -- dataset protocol --------------------------------------------------

    def __getitem__(self, idx):
        boxes, segs, labels = self._load_anno(idx)
        if len(segs) == 0:
            # the reference substitutes the next image's sample but reports
            # this idx (cityscapes.py:106-114); here iteratively, at most
            # once round the split
            for step in range(1, len(self)):
                j = (idx + step) % len(self)
                boxes, segs, labels = self._load_anno(j)
                if len(segs) > 0:
                    img, target, _ = self._build_sample(j, boxes, segs, labels)
                    return img, target, idx
            raise RuntimeError(
                "CityScapesDataset: no image in the split has annotations (split={!r}, "
                "min_area={}): nothing to substitute for empty sample {}".format(
                    self.split, self.min_area, idx))
        return self._build_sample(idx, boxes, segs, labels)

    def _build_sample(self, idx, boxes, segs, labels):
        img = self._load_image(idx)
        size = (img.shape[1], img.shape[0])
        target = BoxList(np.asarray(boxes, np.float32), size, mode="xyxy")
        target.add_field("labels", np.asarray(labels, np.int64))
        target.add_field("masks", SegmentationMask(segs, size, mode=self.mode))
        if self.transforms is not None:
            img, target = self.transforms(img, target)
        return img, target, idx

    def get_img_info(self, index):
        # every Cityscapes frame is 2048x1024
        return {"height": 1024, "width": 2048, "idx": index,
                "img_path": self.img_paths[index], "ann_path": self.ann_paths[index]}

    def map_class_id_to_class_name(self, class_id):
        return self.CLASSES[class_id]
