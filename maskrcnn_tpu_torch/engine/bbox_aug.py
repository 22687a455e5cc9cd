"""Test-time bounding-box augmentation: several scales, each also flipped.

Port of maskrcnn_tpu/engine/bbox_aug.py (after the reference
maskrcnn_benchmark/engine/bbox_aug.py). Every image goes through the passes
of ``tta_passes`` in order: INPUT.MIN_SIZE_TEST at INPUT.MAX_SIZE_TEST, its
left-right flip under TEST.BBOX_AUG.H_FLIP, then each of
TEST.BBOX_AUG.SCALES at TEST.BBOX_AUG.MAX_SIZE, each followed by its flip
under TEST.BBOX_AUG.SCALE_H_FLIP. A pass resizes the image (data/transforms
Resize, no Pillow), normalizes it, zero-pads it to a multiple of
DATALOADER.SIZE_DIVISIBILITY and runs ``infer_forward`` at batch 1 on the
model's device; its detections come back to the original image, flipped
back for a flipped pass. The passes of an image are concatenated and one
host NMS in float64 over all of them, every label together, keeps at most
ROI_HEADS.DETECTIONS_PER_IMG at ROI_HEADS.NMS (structures/boxlist_ops.py:
boxlist_nms), as the JAX package merges them.

The BoxLists hold boxes, "scores" and "labels" only: a pass's masks would
stay in the flipped image's orientation (BoxList.transpose leaves an array
field as it is), so TTA answers box queries alone (engine/inference.py
refuses "segm" and "keypoints" with it).
"""

import random

import numpy as np
import torch

from ..data.transforms import Compose, Normalize, Resize, ToArray
from ..structures.boxlist import FLIP_LEFT_RIGHT
from ..structures.boxlist_ops import boxlist_nms, cat_boxlist

BOX_FIELDS = ("boxes", "scores", "labels", "valid")


def tta_passes(cfg):
    """[(min_size, max_size, hflip)] of every pass, in the order they run."""
    aug = cfg.TEST.BBOX_AUG
    passes = [(cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST, False)]
    if aug.H_FLIP:
        passes.append((cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST, True))
    for scale in aug.SCALES:
        passes.append((scale, aug.MAX_SIZE, False))
        if aug.SCALE_H_FLIP:
            passes.append((scale, aug.MAX_SIZE, True))
    return passes


def pass_input(image, target_scale, target_max_size, cfg, hflip=False):
    """One pass's input for an HWC uint8 RGB image: (the normalized image
    zero-padded to SIZE_DIVISIBILITY [1, Hp, Wp, 3] float32, its size
    [1, 2] int32 (h, w) before padding), as numpy arrays."""
    rng = random.Random(0)
    transform = Compose([
        Resize(target_scale, target_max_size, rng),
        ToArray(),
        Normalize(cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD, cfg.INPUT.TO_BGR255),
    ], rng)
    if hflip:
        image = image[:, ::-1]
    arr, _ = transform(image, None)
    h, w = arr.shape[:2]
    div = max(cfg.DATALOADER.SIZE_DIVISIBILITY, 1)
    padded = np.zeros((1, -(-h // div) * div, -(-w // div) * div, 3), np.float32)
    padded[0, :h, :w] = arr
    return padded, np.asarray([[h, w]], np.int32)


def im_detect_bbox(model, images, target_scale, target_max_size, cfg, hflip=False):
    """One pass over a list of HWC uint8 RGB images, infer_forward at batch 1
    on the model's device: a BoxList of boxes, scores and labels per image,
    on the original image."""
    from .inference import detections_to_boxlists

    device = next(model.parameters()).device
    results = []
    for image in images:
        padded, sizes = pass_input(image, target_scale, target_max_size, cfg, hflip)
        with torch.inference_mode():
            det = model.infer_forward({"images": torch.from_numpy(padded).to(device),
                                       "image_sizes": torch.from_numpy(sizes).to(device)})
            det = {k: det[k].cpu() for k in BOX_FIELDS}
        (bl,) = detections_to_boxlists(det, sizes)
        bl = bl.resize((image.shape[1], image.shape[0]))
        if hflip:
            bl = bl.transpose(FLIP_LEFT_RIGHT)
        results.append(bl)
    return results


def merge_passes(boxlists, cfg):
    """One image's passes concatenated, then one NMS over all of them."""
    return boxlist_nms(cat_boxlist(boxlists), cfg.MODEL.ROI_HEADS.NMS,
                       max_proposals=cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG)


def im_detect_bbox_aug(model, images, cfg):
    """Every pass of tta_passes(cfg) over a list of HWC uint8 RGB images,
    merged: one BoxList per image, on the original image."""
    per_image = [[] for _ in images]
    for min_size, max_size, hflip in tta_passes(cfg):
        for i, bl in enumerate(im_detect_bbox(model, images, min_size, max_size, cfg, hflip)):
            per_image[i].append(bl)
    return [merge_passes(bls, cfg) for bls in per_image]
