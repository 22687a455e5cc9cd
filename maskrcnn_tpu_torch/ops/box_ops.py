"""Box math with the reference's ``+1`` pixel convention.

PyTorch counterpart of maskrcnn_tpu/ops/box_ops.py: area, IoU, encode,
decode, clip, small-box filter. Boxes are xyxy [..., N, 4].
  * width = x2 - x1 + 1
  * decode subtracts 1 from x2/y2
  * dw/dh clipped at log(1000/16) before exp
"""

import math

import torch

TO_REMOVE = 1.0
BBOX_XFORM_CLIP = math.log(1000.0 / 16)


def box_area(boxes):
    return (boxes[..., 2] - boxes[..., 0] + TO_REMOVE) * (
        boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    )


def box_iou(boxes1, boxes2):
    """Pairwise IoU. [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt + TO_REMOVE).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def encode_boxes(reference_boxes, proposals, weights=(1.0, 1.0, 1.0, 1.0)):
    """Regression targets (dx, dy, dw, dh) mapping `proposals` onto
    `reference_boxes` (the gt), as the reference BoxCoder.encode. Widths
    are floored at 1e-6 so padded boxes keep the log finite (their targets
    are masked out by the callers)."""
    wx, wy, ww, wh = weights
    ex_w = proposals[..., 2] - proposals[..., 0] + TO_REMOVE
    ex_h = proposals[..., 3] - proposals[..., 1] + TO_REMOVE
    ex_cx = proposals[..., 0] + 0.5 * ex_w
    ex_cy = proposals[..., 1] + 0.5 * ex_h
    gt_w = reference_boxes[..., 2] - reference_boxes[..., 0] + TO_REMOVE
    gt_h = reference_boxes[..., 3] - reference_boxes[..., 1] + TO_REMOVE
    gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
    gt_cy = reference_boxes[..., 1] + 0.5 * gt_h
    ex_w = ex_w.clamp(min=1e-6)
    ex_h = ex_h.clamp(min=1e-6)
    gt_w = gt_w.clamp(min=1e-6)
    gt_h = gt_h.clamp(min=1e-6)
    return torch.stack([
        wx * (gt_cx - ex_cx) / ex_w,
        wy * (gt_cy - ex_cy) / ex_h,
        ww * torch.log(gt_w / ex_w),
        wh * torch.log(gt_h / ex_h),
    ], dim=-1)


def decode_boxes(rel_codes, boxes, weights=(1.0, 1.0, 1.0, 1.0)):
    """rel_codes [..., N, 4k], boxes [..., N, 4] -> [..., N, 4k]."""
    boxes = boxes.to(rel_codes.dtype)
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    heights = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    dx = rel_codes[..., 0::4] / wx
    dy = rel_codes[..., 1::4] / wy
    dw = torch.clamp(rel_codes[..., 2::4] / ww, max=BBOX_XFORM_CLIP)
    dh = torch.clamp(rel_codes[..., 3::4] / wh, max=BBOX_XFORM_CLIP)

    pred_ctr_x = dx * widths[..., None] + ctr_x[..., None]
    pred_ctr_y = dy * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]
    out = torch.stack(
        [
            pred_ctr_x - 0.5 * pred_w,
            pred_ctr_y - 0.5 * pred_h,
            pred_ctr_x + 0.5 * pred_w - 1,
            pred_ctr_y + 0.5 * pred_h - 1,
        ],
        dim=-1,
    )
    return out.reshape(rel_codes.shape)


def clip_boxes_to_image(boxes, image_size):
    """Clip to [0, size-1]; image_size = (h, w), scalars or tensors that
    broadcast against boxes[..., 0]."""
    h, w = image_size
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w - TO_REMOVE)
    y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h - TO_REMOVE)
    x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w - TO_REMOVE)
    y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h - TO_REMOVE)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def small_box_mask(boxes, min_size):
    ws = boxes[..., 2] - boxes[..., 0] + TO_REMOVE
    hs = boxes[..., 3] - boxes[..., 1] + TO_REMOVE
    return (ws >= min_size) & (hs >= min_size)
