"""Batch collation: host samples -> one fixed-shape padded batch.

Port copy of maskrcnn_tpu/data/collate.py. The batch is a dict of numpy
arrays in the layouts ``GeneralizedRCNN.train_forward`` takes:

  images [B, Hb, Wb, 3], image_sizes [B, 2], indices [B],
  gt_boxes [B, G, 4], gt_labels [B, G], gt_masks [B, G, S, S] (mask models),
  gt_keypoints [B, G, 17, 3] float32 (keypoint models; the same gt order and
  cut as the boxes, all zero where an image has no keypoint field).

Image shapes snap to a small bucket set (portrait / landscape of the
configured sizes), so the card sees few shapes. Each instance's polygons
are rasterized here once, cropped to its gt box at GT_MASK_SIZE; the model
crops them to the proposals on the device (mask_head.project_gt_masks).
"""

import math

import numpy as np


def _round_up(x, m):
    return int(math.ceil(x / m) * m)


def compute_image_buckets(cfg, is_train):
    """Static (H, W) bucket list covering every possible resized image."""
    if len(cfg.TPU.IMAGE_BUCKETS) > 0:
        return [tuple(b) for b in cfg.TPU.IMAGE_BUCKETS]
    div = max(cfg.DATALOADER.SIZE_DIVISIBILITY, 32)
    if is_train:
        min_size = max(cfg.INPUT.MIN_SIZE_TRAIN)
        max_size = cfg.INPUT.MAX_SIZE_TRAIN
    else:
        min_size = cfg.INPUT.MIN_SIZE_TEST
        max_size = cfg.INPUT.MAX_SIZE_TEST
    a = _round_up(min_size, div)
    b = _round_up(max_size, div)
    return [(a, b), (b, a)]  # landscape, portrait


def pick_bucket(buckets, h, w):
    """Smallest bucket that fits (h, w); where none does (a test batch that
    mixes portrait and landscape images: the test loader does not group by
    aspect ratio), the largest height by the largest width of the buckets.
    The JAX package falls back to its largest bucket, which such a batch
    overflows (ROADMAP.md Queue 3)."""
    best = None
    for bh, bw in buckets:
        if h <= bh and w <= bw:
            area = bh * bw
            if best is None or area < best[0]:
                best = (area, (bh, bw))
    if best is None:
        return max(b[0] for b in buckets), max(b[1] for b in buckets)
    return best[1]


class BatchCollator:
    def __init__(self, cfg, is_train=True, patch_cache_size=200_000):
        self.cfg = cfg
        self.is_train = is_train
        self.buckets = compute_image_buckets(cfg, is_train)
        self.max_gt = cfg.TPU.MAX_GT_BOXES
        self.mask_size = cfg.TPU.GT_MASK_SIZE
        self.mask_on = cfg.MODEL.MASK_ON
        self.keypoint_on = cfg.MODEL.KEYPOINT_ON
        # Polygon mask-patch cache. A polygon instance cropped to its own gt
        # box and resized to a fixed SxS patch is EXACTLY invariant to the
        # (random multi-scale) Resize transform — both polygon and box scale
        # by the same affine, so box-local normalized coordinates are
        # unchanged — and depends on the flip transforms only through the
        # flip bits. So each instance rasterizes at most once per flip state
        # over the whole training run (the reference re-rasterizes every
        # epoch inside mask_head/loss.py project_masks_on_boxes).
        self._patch_cache = {}
        self._patch_cache_cap = patch_cache_size

    def __call__(self, batch):
        """batch: list of (image HWC, BoxList target, dataset index)."""
        images = [b[0] for b in batch]
        targets = [b[1] for b in batch]
        idxs = np.asarray([b[2] for b in batch], np.int64)

        max_h = max(im.shape[0] for im in images)
        max_w = max(im.shape[1] for im in images)
        bh, bw = pick_bucket(self.buckets, max_h, max_w)

        n = len(images)
        # uint8 when normalization is deferred to the device
        # (TPU.DEVICE_NORMALIZE): 4x less to pass and copy than float32
        out_images = np.zeros((n, bh, bw, 3), images[0].dtype)
        image_sizes = np.zeros((n, 2), np.int32)
        for i, im in enumerate(images):
            h, w = im.shape[:2]
            out_images[i, :h, :w] = im
            image_sizes[i] = (h, w)

        out = dict(images=out_images, image_sizes=image_sizes, indices=idxs)
        if targets[0] is None or self.is_train is False:
            return out

        g = self.max_gt
        gt_boxes = np.zeros((n, g, 4), np.float32)
        gt_labels = np.zeros((n, g), np.int32)
        if self.mask_on:
            s = self.mask_size
            gt_masks = np.zeros((n, g, s, s), np.uint8)
        if self.keypoint_on:
            gt_kps = np.zeros((n, g, 17, 3), np.float32)

        for i, t in enumerate(targets):
            t = t.convert("xyxy")
            k = min(len(t), g)
            gt_boxes[i, :k] = t.bbox[:k]
            gt_labels[i, :k] = np.asarray(t.get_field("labels"))[:k]
            if self.mask_on and t.has_field("masks"):
                masks = t.get_field("masks")
                cacheable = getattr(masks, "mode", None) == "poly"
                flips = (
                    getattr(t, "_hflipped", False),
                    getattr(t, "_vflipped", False),
                )
                for j in range(k):
                    key = (int(idxs[i]), j, flips)
                    if cacheable and key in self._patch_cache:
                        gt_masks[i, j] = self._patch_cache[key]
                        continue
                    box = t.bbox[j]
                    inst = masks[j]
                    patch = (
                        inst.crop(box).resize((self.mask_size, self.mask_size))
                    )
                    m = patch.get_mask_tensor()
                    if m.ndim == 3:
                        m = m[0]
                    gt_masks[i, j] = m
                    if cacheable and len(self._patch_cache) < self._patch_cache_cap:
                        self._patch_cache[key] = m
            if self.keypoint_on and t.has_field("keypoints"):
                gt_kps[i, :k] = t.get_field("keypoints").to_array()[:k]

        out["gt_boxes"] = gt_boxes
        out["gt_labels"] = gt_labels
        if self.mask_on:
            out["gt_masks"] = gt_masks
        if self.keypoint_on:
            out["gt_keypoints"] = gt_kps
        return out


class BBoxAugCollator:
    """The test loader's collator under test-time augmentation (JAX
    data/collate.py:BBoxAugCollator, after the reference
    data/collate_batch.py): the samples stay as they are, (images, targets,
    indices) tuples of the untransformed HWC uint8 RGB images; each pass
    of engine/bbox_aug.py transforms them itself."""

    def __call__(self, batch):
        return list(zip(*batch))
