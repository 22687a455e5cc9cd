"""Fixed-shape (padded) batched greedy NMS returning keep-masks.

PyTorch counterpart of maskrcnn_tpu/ops/nms.py. Semantics: boxes are
visited in descending score order (stable: ties keep input order), IoU uses
the +1 convention, a box is suppressed by a kept earlier one when
IoU > threshold, and rows with valid=False are never kept and never suppress.

``batched_nms`` is the wrapper the model calls: on a CPU tensor it runs the
plain version ``batched_nms_plain``; on a CUDA tensor it launches the
hand-written kernel (csrc/nms.cu), which replaces the TPU kernel
ops/pallas/nms_kernel.py:nms_mask_pallas. There is no fallback between the
two.
"""

import ctypes

import torch

from . import native
from .box_ops import box_iou

NEG_INF = -1e10


def _sort_lanes(boxes, scores, valid):
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.sort(masked, dim=1, descending=True, stable=True).indices
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    svalid = torch.gather(valid, 1, order)
    return order, sboxes, svalid


def _unsort(order, keep_sorted):
    return torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)


def batched_nms_plain(boxes, scores, valid, iou_threshold):
    """boxes [G, N, 4], scores [G, N], valid [G, N] bool -> keep [G, N]
    bool in the original order. The greedy scan of ops/nms.py:nms_mask,
    over all lanes at once."""
    g, n, _ = boxes.shape
    order, sboxes, keep = _sort_lanes(boxes, scores, valid)
    later = torch.ones((n, n), dtype=torch.bool, device=boxes.device).triu(1)
    sup = (box_iou(sboxes, sboxes) > iou_threshold) & later  # [G, N, N]
    for i in range(n):
        keep = keep & ~(keep[:, i:i + 1] & sup[:, i])
    return _unsort(order, keep)


def _lib():
    lib = native.load("nms")
    if not getattr(lib, "_typed", False):
        lib.nms_keep_sorted.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.nms_keep_sorted.restype = ctypes.c_int
        lib.nms_max_boxes.restype = ctypes.c_int
        lib._typed = True
    return lib


def launch_sorted(sboxes, svalid, mask, keep, iou_threshold):
    """The kernel alone, on prepared buffers: score-sorted boxes [G, N, 4]
    f32 and valid [G, N] uint8 in, scratch mask [G, N, ceil(N/64)] int64,
    keep [G, N] uint8 out in sorted order. Launches on the current stream."""
    g, n = svalid.shape
    stream = torch.cuda.current_stream(sboxes.device).cuda_stream
    rc = _lib().nms_keep_sorted(
        sboxes.data_ptr(), svalid.data_ptr(), mask.data_ptr(), keep.data_ptr(),
        g, n, float(iou_threshold), stream,
    )
    native.check(rc, "nms")


def _batched_nms_cuda(boxes, scores, valid, iou_threshold):
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError("nms kernel takes float32 boxes and scores")
    if valid.dtype != torch.bool:
        raise TypeError("nms kernel takes a bool valid mask")
    if not (boxes.device == scores.device == valid.device):
        raise ValueError("boxes, scores and valid must share one device")
    g, n, _ = boxes.shape
    if n > _lib().nms_max_boxes():
        raise ValueError("nms kernel takes at most {} boxes per lane, got {}"
                         .format(_lib().nms_max_boxes(), n))
    if g == 0 or n == 0:
        return torch.zeros((g, n), dtype=torch.bool, device=boxes.device)
    order, sboxes, svalid = _sort_lanes(boxes, scores, valid)
    sboxes = sboxes.contiguous()
    svalid = svalid.to(torch.uint8).contiguous()
    mask = torch.empty((g, n, (n + 63) // 64), dtype=torch.int64, device=boxes.device)
    keep = torch.empty((g, n), dtype=torch.uint8, device=boxes.device)
    launch_sorted(sboxes, svalid, mask, keep, iou_threshold)
    batched_nms.launches += 1
    return _unsort(order, keep.bool())


def batched_nms(boxes, scores, valid, iou_threshold):
    """Keep-mask NMS over lanes: boxes [G, N, 4] f32, scores [G, N] f32,
    valid [G, N] bool -> keep [G, N] bool, original order."""
    if boxes.ndim != 3 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:2]:
        raise ValueError("expected boxes [G, N, 4] and scores [G, N], got {} and {}"
                         .format(tuple(boxes.shape), tuple(scores.shape)))
    if valid.shape != scores.shape:
        raise ValueError("valid must match scores' shape")
    if boxes.device.type == "cpu":
        return batched_nms_plain(boxes, scores, valid, iou_threshold)
    if boxes.device.type != "cuda":
        raise ValueError("nms runs on cpu or cuda tensors, not {}".format(boxes.device))
    return _batched_nms_cuda(boxes, scores, valid, iou_threshold)


batched_nms.launches = 0
