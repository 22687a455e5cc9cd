"""Mask pasting: fixed-size mask probabilities -> full-image binary masks.

PyTorch counterpart of maskrcnn_tpu/models/masker.py (the reference's
expand_masks / paste_mask_in_image), run on the device for all detections
at once. Each M x M mask gets a zero border of `padding` cells, its box is
expanded by (M + 2 padding) / M and truncated to integers, the padded mask
is resized bilinearly to the box's (h, w) and thresholded (or, with a
negative threshold, scaled to 0-255 grey levels), and the result is written
into the image where the box overlaps it.

The resize is separable: for every detection, one [H, M + 2p] matrix of
row weights and one [W, M + 2p] matrix of column weights hold the bilinear
weights of cv2's INTER_LINEAR (half-pixel centres, ``align_corners=False``,
coordinates clamped at the border), zero outside the box; the pasted
probabilities are ``rows @ mask @ cols^T``. Both sides compute in float32,
so a pixel can differ from cv2's only where the probability sits at the
threshold.
"""

import torch
import torch.nn.functional as F


def expand_boxes(boxes, scale):
    """Scale xyxy boxes [N, 4] about their centres."""
    w_half = (boxes[:, 2] - boxes[:, 0]) * 0.5 * scale
    h_half = (boxes[:, 3] - boxes[:, 1]) * 0.5 * scale
    x_c = (boxes[:, 2] + boxes[:, 0]) * 0.5
    y_c = (boxes[:, 3] + boxes[:, 1]) * 0.5
    return torch.stack([x_c - w_half, y_c - h_half, x_c + w_half, y_c + h_half], dim=1)


def _axis_weights(start, end, size, src):
    """Bilinear weights [N, size, src] that resize a length-`src` axis onto
    the integer span [start, end] of an image axis of length `size` (zero
    rows outside the span)."""
    dst = torch.clamp(end - start + 1, min=1).float()  # [N]
    pos = torch.arange(size, device=start.device)
    local = (pos[None, :] - start[:, None]).float()  # [N, size]
    inside = (pos[None, :] >= start[:, None]) & (pos[None, :] <= end[:, None])
    coord = torch.clamp((local + 0.5) * (src / dst[:, None]) - 0.5, min=0.0)
    lo = torch.clamp(coord.floor().long(), max=src - 1)
    hi = torch.clamp(lo + 1, max=src - 1)
    frac = torch.where(lo >= src - 1, torch.zeros_like(coord), coord - lo.float())
    frac = torch.where(inside, frac, torch.zeros_like(frac))
    keep = inside.float()
    w = F.one_hot(lo, src).float() * ((1.0 - frac) * keep)[..., None]
    return w + F.one_hot(hi, src).float() * frac[..., None]


THRESHOLD = 0.5
PADDING = 1


def paste_masks_in_image(masks, boxes, im_h, im_w, threshold=THRESHOLD, padding=PADDING):
    """masks [N, M, M] probabilities, boxes [N, 4] xyxy in image pixels ->
    [N, im_h, im_w] uint8: binary masks (probability > threshold) when
    threshold >= 0, else the probabilities as 0-255 grey levels (times 255,
    truncated: the Masker's heatmap mode, threshold -1)."""
    n, m = masks.shape[0], masks.shape[-1]
    if n == 0:
        return torch.zeros((0, im_h, im_w), dtype=torch.uint8, device=masks.device)
    padded = F.pad(masks.float(), (padding,) * 4)
    src = m + 2 * padding
    box = expand_boxes(boxes.float(), src / m).to(torch.int64)  # truncation
    rows = _axis_weights(box[:, 1], box[:, 3], im_h, src)  # [N, H, S]
    cols = _axis_weights(box[:, 0], box[:, 2], im_w, src)  # [N, W, S]
    probs = rows @ padded @ cols.transpose(1, 2)  # [N, H, W]
    if threshold >= 0:
        return (probs > threshold).to(torch.uint8)
    return (probs * 255).to(torch.uint8)
