"""COCO dataset.

Port copy of maskrcnn_tpu/data/datasets/coco.py (after the reference
maskrcnn_benchmark/data/datasets/coco.py, without pycocotools): the
annotation JSON read with ``json``; images without usable annotations
dropped for training; crowd annotations left out of the targets;
contiguous category ids and, for the evaluator, their map back to the
JSON's and the map of dataset index to image id (``id_to_img_map``);
targets are BoxLists with "labels" and, for polygon segmentations,
"masks". Images are HWC uint8 RGB numpy arrays,
decoded with Pillow (imported in ``_load_image`` only). Keypoint targets
wait for the keypoint family.
"""

import json
import os

import numpy as np

from ...structures import BoxList, SegmentationMask


def _has_valid_annotation(anno):
    if len(anno) == 0:
        return False
    # boxes with nearly-zero area are degenerate
    if all(any(o <= 1 for o in obj["bbox"][2:]) for obj in anno):
        return False
    if "keypoints" not in anno[0]:
        return True
    # keypoints task: at least min_keypoints visible
    return sum(sum(1 for v in obj["keypoints"][2::3] if v > 0) for obj in anno) >= 10


class COCODataset:
    def __init__(
        self, ann_file, root, remove_images_without_annotations=False, transforms=None
    ):
        self.root = root
        self.ann_file = ann_file
        with open(ann_file) as f:
            data = json.load(f)

        self.imgs = {img["id"]: img for img in data["images"]}
        self.anns_by_img = {img_id: [] for img_id in self.imgs}
        for ann in data.get("annotations", []):
            if ann["image_id"] in self.anns_by_img:
                self.anns_by_img[ann["image_id"]].append(ann)

        self.ids = sorted(self.imgs.keys())
        if remove_images_without_annotations:
            self.ids = [
                i
                for i in self.ids
                if _has_valid_annotation(
                    [a for a in self.anns_by_img[i] if a.get("iscrowd", 0) == 0]
                )
            ]

        cats = sorted(data["categories"], key=lambda c: c["id"])
        self.categories = {c["id"]: c["name"] for c in cats}
        self.json_category_id_to_contiguous_id = {
            c["id"]: i + 1 for i, c in enumerate(cats)
        }
        self.contiguous_category_id_to_json_id = {
            v: k for k, v in self.json_category_id_to_contiguous_id.items()
        }
        self.id_to_img_map = {k: v for k, v in enumerate(self.ids)}
        self.transforms = transforms

    def __len__(self):
        return len(self.ids)

    def get_img_info(self, index):
        img = self.imgs[self.ids[index]]
        return {"height": img["height"], "width": img["width"], **img}

    def _load_image(self, index):
        from PIL import Image

        info = self.imgs[self.ids[index]]
        path = os.path.join(self.root, info["file_name"])
        with Image.open(path) as im:
            return np.array(im.convert("RGB"))

    def get_target(self, index):
        img_id = self.ids[index]
        info = self.imgs[img_id]
        w, h = info["width"], info["height"]
        anno = [a for a in self.anns_by_img[img_id] if a.get("iscrowd", 0) == 0]

        boxes = np.asarray([a["bbox"] for a in anno], np.float32).reshape(-1, 4)
        target = BoxList(boxes, (w, h), mode="xywh").convert("xyxy")

        classes = np.asarray(
            [self.json_category_id_to_contiguous_id[a["category_id"]] for a in anno],
            np.int64,
        )
        target.add_field("labels", classes)

        if anno and "segmentation" in anno[0]:
            masks = [a["segmentation"] for a in anno]
            target.add_field("masks", SegmentationMask(masks, (w, h), mode="poly"))
        if anno and "keypoints" in anno[0]:
            raise NotImplementedError("keypoint targets wait for the keypoint family")

        return target.clip_to_image(remove_empty=True)

    def __getitem__(self, index):
        img = self._load_image(index)
        target = self.get_target(index)
        if self.transforms is not None:
            img, target = self.transforms(img, target)
        return img, target, index
