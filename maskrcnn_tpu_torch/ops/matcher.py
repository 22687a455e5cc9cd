"""Anchor/proposal-to-ground-truth matching with fixed shapes.

PyTorch counterpart of maskrcnn_tpu/ops/matcher.py. Per anchor (or
proposal): the index of the best-IoU valid gt (first index on ties), or the
reference Matcher's sentinels BELOW_LOW_QUALITY (-1) / BETWEEN_THRESHOLDS
(-2).

``match_anchors_batched`` is the RPN's wrapper: on CPU tensors it runs the
plain version ``match_anchors_plain``; on CUDA tensors it launches the
hand-written kernel csrc/matcher.cu, which replaces the TPU kernel
ops/pallas/matcher_kernel.py:match_anchors_pallas. There is no fallback
between the two.
"""

import ctypes

import torch

from . import native
from .box_ops import box_iou

BELOW_LOW_QUALITY = -1
BETWEEN_THRESHOLDS = -2


def _thresholds(vals, matches, high, low):
    out = torch.where(vals < low, torch.full_like(matches, BELOW_LOW_QUALITY), matches)
    between = (vals >= low) & (vals < high)
    return torch.where(between, torch.full_like(matches, BETWEEN_THRESHOLDS), out)


def match_proposals(iou, gt_valid, high_threshold, low_threshold,
                    allow_low_quality_matches=False):
    """iou [..., G, N] (gt x proposals), gt_valid [..., G] bool -> matches
    [..., N] int32: >= 0 gt index, -1 below low, -2 between."""
    iou = torch.where(gt_valid[..., :, None], iou, torch.full_like(iou, -1.0))
    vals, matches = iou.max(dim=-2)  # first index of the maximum
    matches = matches.to(torch.int32)
    out = _thresholds(vals, matches, high_threshold, low_threshold)
    if allow_low_quality_matches:
        best = iou.max(dim=-1, keepdim=True).values  # [..., G, 1]
        is_best = (iou == best) & gt_valid[..., :, None] & (best > 0)
        out = torch.where(is_best.any(dim=-2), matches, out)
    return out


def match_anchors_plain(anchors, gt_boxes, gt_valid, high_threshold, low_threshold):
    """anchors [N, 4], gt_boxes [B, G, 4], gt_valid [B, G] -> [B, N] int32.

    match_proposals(box_iou(gt, anchors), ..., allow_low_quality=True) per
    image (ops/matcher.py:match_anchors_streaming's contract), one image at
    a time so that only one [G, N] IoU table is alive."""
    b, n = gt_boxes.shape[0], anchors.shape[0]
    if gt_boxes.shape[1] == 0:
        return torch.full((b, n), BELOW_LOW_QUALITY, dtype=torch.int32, device=anchors.device)
    return torch.stack([
        match_proposals(box_iou(gt_boxes[i], anchors), gt_valid[i], high_threshold,
                        low_threshold, allow_low_quality_matches=True)
        for i in range(b)
    ])


def match_anchors_blocked(anchors, gt_boxes, gt_valid, high_threshold, low_threshold,
                          tile=512, grid=4):
    """The CUDA kernel's algorithm in plain PyTorch, for the tests: the
    contract of ``match_anchors_plain`` with the kernel's pruned restore.

    The kernel's blocks walk anchor tiles of `tile` grid-stride, so anchor i
    belongs to block (i // tile) % grid. Pass 1: each anchor's first best
    valid gt, thresholded, and each block's maximum IoU per gt; a gt's best
    is the maximum over blocks. Pass 2 revisits a block's anchors only for
    the valid gt j whose block maximum equals best[j] > 0, and restores the
    anchors there whose IoU with j equals best[j]."""
    b, n = gt_boxes.shape[0], anchors.shape[0]
    block = (torch.arange(n, device=anchors.device) // tile) % grid
    out = []
    for k in range(b):
        iou = box_iou(gt_boxes[k], anchors)  # [G, N]
        iou = torch.where(gt_valid[k][:, None], iou, torch.full_like(iou, -1.0))
        if iou.shape[0] == 0:
            out.append(torch.full((n,), BELOW_LOW_QUALITY, dtype=torch.int32,
                                  device=anchors.device))
            continue
        vals, matches = iou.max(dim=0)
        m = _thresholds(vals, matches.to(torch.int32), high_threshold, low_threshold)
        bmax = torch.stack([torch.where(block[None] == q, iou, torch.full_like(iou, -1.0))
                            .max(dim=1).values for q in range(grid)])  # [grid, G]
        best = bmax.max(dim=0).values
        hit = (bmax == best) & (best > 0) & gt_valid[k]  # [grid, G]
        revisit = hit[block].T  # [G, N]: anchor i's block holds gt j's best
        restore = (revisit & (iou == best[:, None])).any(dim=0)
        out.append(torch.where(restore, matches.to(torch.int32), m))
    return torch.stack(out) if out else torch.empty((0, n), dtype=torch.int32,
                                                    device=anchors.device)


def _lib():
    lib = native.load("matcher")
    if not getattr(lib, "_typed", False):
        lib.match_anchors.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.match_anchors.restype = ctypes.c_int
        lib.match_anchors_max_gt.restype = ctypes.c_int
        lib._typed = True
    return lib


def launch(anchors, gt_boxes, gt_valid, high_threshold, low_threshold, best, out):
    """The kernel alone, on prepared buffers: anchors [N, 4] f32, gt_boxes
    [B, G, 4] f32, gt_valid [B, G] bool in; scratch best [B, G] int32 (the
    kernel zeroes it); out [B, N] int32. One cooperative launch on the
    current stream."""
    b, g = gt_valid.shape
    stream = torch.cuda.current_stream(anchors.device).cuda_stream
    rc = _lib().match_anchors(
        anchors.data_ptr(), gt_boxes.data_ptr(), gt_valid.data_ptr(),
        anchors.shape[0], b, g, float(high_threshold), float(low_threshold),
        best.data_ptr(), out.data_ptr(), stream,
    )
    native.check(rc, "matcher")


def _match_cuda(anchors, gt_boxes, gt_valid, high_threshold, low_threshold):
    if anchors.dtype != torch.float32 or gt_boxes.dtype != torch.float32:
        raise TypeError("matcher kernel takes float32 anchors and gt boxes")
    if gt_valid.dtype != torch.bool:
        raise TypeError("matcher kernel takes a bool gt_valid mask")
    if not (anchors.device == gt_boxes.device == gt_valid.device):
        raise ValueError("anchors, gt_boxes and gt_valid must share one device")
    b, g, _ = gt_boxes.shape
    if g > _lib().match_anchors_max_gt():
        raise ValueError("matcher kernel takes at most {} gt per image, got {}"
                         .format(_lib().match_anchors_max_gt(), g))
    n = anchors.shape[0]
    out = torch.empty((b, n), dtype=torch.int32, device=anchors.device)
    if b == 0 or n == 0:
        return out
    best = torch.empty((b, max(g, 1)), dtype=torch.int32, device=anchors.device)
    launch(anchors.contiguous(), gt_boxes.contiguous(), gt_valid.contiguous(),
           high_threshold, low_threshold, best, out)
    match_anchors_batched.launches += 1
    return out


def match_anchors_batched(anchors, gt_boxes, gt_valid, high_threshold, low_threshold):
    """Batched allow-low-quality anchor matcher: anchors [N, 4] (shared by
    the batch), gt_boxes [B, G, 4], gt_valid [B, G] bool -> [B, N] int32."""
    if anchors.ndim != 2 or anchors.shape[-1] != 4 or gt_boxes.ndim != 3 or gt_boxes.shape[-1] != 4:
        raise ValueError("expected anchors [N, 4] and gt_boxes [B, G, 4], got {} and {}"
                         .format(tuple(anchors.shape), tuple(gt_boxes.shape)))
    if gt_valid.shape != gt_boxes.shape[:2]:
        raise ValueError("gt_valid must be [B, G]")
    if anchors.device.type == "cpu":
        return match_anchors_plain(anchors, gt_boxes, gt_valid, high_threshold, low_threshold)
    if anchors.device.type != "cuda":
        raise ValueError("matcher runs on cpu or cuda tensors, not {}".format(anchors.device))
    return _match_cuda(anchors, gt_boxes, gt_valid, high_threshold, low_threshold)


match_anchors_batched.launches = 0
