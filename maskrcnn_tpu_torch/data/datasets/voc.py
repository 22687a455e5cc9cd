"""Pascal VOC dataset (XML annotations).

Port copy of maskrcnn_tpu/data/datasets/voc.py (after the reference
maskrcnn_benchmark/data/datasets/voc.py:17-128): the image set of a split,
each image's XML parsed with the standard library, boxes moved to 0-based
pixels, difficult objects kept only with use_difficult (for testing).
Images are HWC uint8 RGB numpy arrays, decoded with Pillow in
``_load_image`` only (override it to hand images over in memory).
"""

import os
import xml.etree.ElementTree as ET

import numpy as np

from ...structures import BoxList


class PascalVOCDataset:
    CLASSES = (
        "__background__ ",
        "aeroplane",
        "bicycle",
        "bird",
        "boat",
        "bottle",
        "bus",
        "car",
        "cat",
        "chair",
        "cow",
        "diningtable",
        "dog",
        "horse",
        "motorbike",
        "person",
        "pottedplant",
        "sheep",
        "sofa",
        "train",
        "tvmonitor",
    )

    def __init__(self, data_dir, split, use_difficult=False, transforms=None):
        self.root = data_dir
        self.image_set = split
        self.keep_difficult = use_difficult
        self.transforms = transforms

        self._annopath = os.path.join(self.root, "Annotations", "%s.xml")
        self._imgpath = os.path.join(self.root, "JPEGImages", "%s.jpg")
        self._imgsetpath = os.path.join(self.root, "ImageSets", "Main", "%s.txt")

        with open(self._imgsetpath % self.image_set) as f:
            self.ids = [x.strip() for x in f.readlines()]
        self.id_to_img_map = {k: v for k, v in enumerate(self.ids)}
        self.class_to_ind = dict(zip(self.CLASSES, range(len(self.CLASSES))))
        self.categories = dict(zip(range(len(self.CLASSES)), self.CLASSES))

    def __len__(self):
        return len(self.ids)

    def _load_image(self, index):
        from PIL import Image

        with Image.open(self._imgpath % self.ids[index]) as im:
            return np.array(im.convert("RGB"))

    def __getitem__(self, index):
        img = self._load_image(index)
        target = self.get_groundtruth(index).clip_to_image(remove_empty=True)
        if self.transforms is not None:
            img, target = self.transforms(img, target)
        return img, target, index

    def get_groundtruth(self, index):
        anno = ET.parse(self._annopath % self.ids[index]).getroot()
        anno = self._preprocess_annotation(anno)
        height, width = anno["im_info"]
        target = BoxList(anno["boxes"], (width, height), mode="xyxy")
        target.add_field("labels", anno["labels"])
        target.add_field("difficult", anno["difficult"])
        return target

    def _preprocess_annotation(self, target):
        boxes = []
        gt_classes = []
        difficult_boxes = []
        TO_REMOVE = 1

        for obj in target.iter("object"):
            difficult = int(obj.find("difficult").text) == 1
            if not self.keep_difficult and difficult:
                continue
            name = obj.find("name").text.lower().strip()
            bb = obj.find("bndbox")
            box = [bb.find(k).text for k in ("xmin", "ymin", "xmax", "ymax")]
            boxes.append(tuple(float(x) - TO_REMOVE for x in box))
            gt_classes.append(self.class_to_ind[name])
            difficult_boxes.append(difficult)

        size = target.find("size")
        im_info = (int(size.find("height").text), int(size.find("width").text))
        return {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(gt_classes, np.int64),
            "difficult": np.asarray(difficult_boxes, np.int64),
            "im_info": im_info,
        }

    def get_img_info(self, index):
        anno = ET.parse(self._annopath % self.ids[index]).getroot()
        size = anno.find("size")
        return {
            "height": int(size.find("height").text),
            "width": int(size.find("width").text),
        }

    def map_class_id_to_class_name(self, class_id):
        return self.CLASSES[class_id]
