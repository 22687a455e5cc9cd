"""Host-side operations on BoxLists (numpy).

Port of maskrcnn_tpu/structures/boxlist_ops.py (after the reference
maskrcnn_benchmark/structures/boxlist_ops.py): NMS of one BoxList in
float64 (ops/nms.py:nms_numpy; test-time augmentation merges its passes
with it), the small-box filter, the IoU of two BoxLists and their
concatenation. The padded on-device versions of box operations are in
ops/box_ops.py.
"""

import numpy as np

from ..ops.nms import nms_numpy
from .boxlist import TO_REMOVE, BoxList


def boxlist_nms(boxlist, nms_thresh, max_proposals=-1, score_field="scores"):
    """The boxes that greedy NMS over all of them, of every label together,
    keeps at IoU `nms_thresh` (none suppressed when it is <= 0), in
    descending score order, the first `max_proposals` when it is positive."""
    if nms_thresh <= 0:
        return boxlist
    mode = boxlist.mode
    boxlist = boxlist.convert("xyxy")
    keep = nms_numpy(boxlist.bbox, boxlist.get_field(score_field), nms_thresh)
    if max_proposals > 0:
        keep = keep[:max_proposals]
    return boxlist[keep].convert(mode)


def remove_small_boxes(boxlist, min_size):
    """The boxes whose width and height (+1 convention) are both >= min_size."""
    xywh = boxlist.convert("xywh").bbox
    keep = (xywh[:, 2] >= min_size) & (xywh[:, 3] >= min_size)
    return boxlist[keep]


def boxlist_iou(boxlist1, boxlist2):
    """Pairwise IoU between two BoxLists on the same image, +1 pixel
    convention. [N, M]."""
    if boxlist1.size != boxlist2.size:
        raise RuntimeError(
            "boxlists should have same image size, got {}, {}".format(boxlist1, boxlist2))
    box1 = boxlist1.convert("xyxy").bbox
    box2 = boxlist2.convert("xyxy").bbox
    area1 = boxlist1.area()
    area2 = boxlist2.area()
    lt = np.maximum(box1[:, None, :2], box2[None, :, :2])
    rb = np.minimum(box1[:, None, 2:], box2[None, :, 2:])
    wh = np.clip(rb - lt + TO_REMOVE, 0, None)
    inter = wh[:, :, 0] * wh[:, :, 1]
    union = area1[:, None] + area2[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)


def cat_boxlist(bboxes):
    """Concatenate BoxLists (same image size, mode and fields)."""
    if not (isinstance(bboxes, (list, tuple)) and bboxes
            and all(isinstance(b, BoxList) for b in bboxes)):
        raise TypeError("cat_boxlist takes a non-empty list of BoxLists")
    size = bboxes[0].size
    mode = bboxes[0].mode
    fields = set(bboxes[0].fields())
    if not all(b.size == size and b.mode == mode and set(b.fields()) == fields for b in bboxes):
        raise ValueError("cat_boxlist: BoxLists differ in image size, mode or fields")

    out = BoxList(np.concatenate([b.bbox for b in bboxes], axis=0), size, mode)
    for field in fields:
        vals = [b.get_field(field) for b in bboxes]
        if isinstance(vals[0], np.ndarray):
            data = np.concatenate(vals, axis=0)
        else:
            data = type(vals[0]).cat(vals)
        out.add_field(field, data)
    return out
