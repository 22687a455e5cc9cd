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

import numpy as np
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


def _suppression(sboxes, iou_threshold, rows=1024):
    """sup [G, N, N] bool: column j comes after row i and IoU(i, j) >
    threshold. The IoU is taken `rows` rows at a time: a lane of 12,000
    boxes holds 144 M pairs, whose float32 IoU at once would take 576 MB
    a lane."""
    g, n, _ = sboxes.shape
    sup = torch.empty((g, n, n), dtype=torch.bool, device=sboxes.device)
    cols = torch.arange(n, device=sboxes.device)
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        later = cols[None, :] > cols[r0:r1, None]
        sup[:, r0:r1] = (box_iou(sboxes[:, r0:r1], sboxes) > iou_threshold) & later
    return sup


def batched_nms_plain(boxes, scores, valid, iou_threshold):
    """boxes [G, N, 4], scores [G, N], valid [G, N] bool -> keep [G, N]
    bool in the original order. The greedy scan of ops/nms.py:nms_mask,
    over all lanes at once."""
    g, n, _ = boxes.shape
    order, sboxes, keep = _sort_lanes(boxes, scores, valid)
    sup = _suppression(sboxes, iou_threshold)
    for i in range(n):
        keep = keep & ~(keep[:, i:i + 1] & sup[:, i])
    return _unsort(order, keep)


def blocked_nms_sorted(sboxes, svalid, iou_threshold, block=64):
    """The CUDA kernel's algorithm in plain PyTorch, for the tests: score-
    sorted boxes [G, N, 4] and valid [G, N] -> keep [G, N] in sorted order.

    Suppression words as the mask launch stores them: sup[g, i, j] when j
    comes after i and IoU(i, j) > threshold, with i a valid row and j a
    valid column (other entries are never read). The walk of the reduce
    launch: `removed` starts as the invalid rows; block k of `block` rows is
    resolved row by row from its own columns (a row still alive removes
    the later rows it names), then the kept rows of the block remove the
    columns after it at once; the walk stops after the last block holding a
    valid row."""
    g, n, _ = sboxes.shape
    later = torch.ones((n, n), dtype=torch.bool, device=sboxes.device).triu(1)
    sup = (box_iou(sboxes, sboxes) > iou_threshold) & later
    sup &= svalid[:, :, None] & svalid[:, None, :]
    removed = ~svalid.clone()
    rows = torch.arange(n, device=sboxes.device)
    last = int(torch.where(svalid, rows + 1, 0).max()) if n else 0
    for k0 in range(0, last, block):
        k1 = min(k0 + block, n)
        cur = removed[:, k0:k1].clone()
        for i in range(k1 - k0):
            cur |= ~cur[:, i:i + 1] & sup[:, k0 + i, k0:k1]
        removed[:, k0:k1] = cur
        hit = (~cur[:, :, None] & sup[:, k0:k1, k1:]).any(dim=1)
        removed[:, k1:] |= hit
    return ~removed


def _lib():
    lib = native.load("nms")
    if not getattr(lib, "_typed", False):
        lib.nms_keep.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.nms_keep.restype = ctypes.c_int
        lib.nms_scratch_words.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.nms_scratch_words.restype = ctypes.c_longlong
        lib.nms_max_boxes.restype = ctypes.c_int
        lib._typed = True
    return lib


def prepare(boxes, scores, valid):
    """The kernel's inputs: (score-sorted boxes [G, N, 4], the sort's order
    [G, N] int64, valid [G, N] bool in the original order, scratch), each
    contiguous: the kernel indexes them by lane * N. The sort's outputs keep
    their input's strides, and the box head hands over transposed scores."""
    g, n = scores.shape
    masked = torch.where(valid, scores, NEG_INF)
    order = torch.sort(masked, dim=1, descending=True, stable=True).indices.contiguous()
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous()
    scratch = torch.empty((_lib().nms_scratch_words(g, n),), dtype=torch.int64,
                          device=boxes.device)
    return sboxes, order, valid.contiguous(), scratch


def launch(sboxes, order, valid, scratch, keep, iou_threshold):
    """The kernel alone, on prepare()'s buffers: writes keep [G, N] bool in
    the original order. Launches on the current stream."""
    g, n = valid.shape
    stream = torch.cuda.current_stream(sboxes.device).cuda_stream
    rc = _lib().nms_keep(
        sboxes.data_ptr(), order.data_ptr(), valid.data_ptr(), scratch.data_ptr(),
        keep.data_ptr(), g, n, float(iou_threshold), stream,
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
    keep = torch.empty((g, n), dtype=torch.bool, device=boxes.device)
    if g == 0 or n == 0:
        return keep
    launch(*prepare(boxes, scores, valid), keep, iou_threshold)
    batched_nms.launches += 1
    return keep


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


def nms_numpy(boxes, scores, iou_threshold):
    """Greedy NMS on the host in float64, the JAX package's
    ops/nms.py:nms_numpy (the reference CPU kernel, csrc/cpu/nms_cpu.cpp):
    boxes [N, 4] xyxy, scores [N] -> the kept indices int64, in descending
    score order (stable), +1 IoU convention, suppressed at IoU > threshold.
    Test-time augmentation merges its passes with it: the card's kernel
    computes its IoU in float32, which could flip a decision at the
    threshold."""
    boxes = np.asarray(boxes, np.float64)
    scores = np.asarray(scores, np.float64)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = np.argsort(-scores, kind="stable")
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for pos, i in enumerate(order):
        if suppressed[i]:
            continue
        keep.append(i)
        rest = order[pos + 1:]
        w = np.maximum(0.0, np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]) + 1)
        h = np.maximum(0.0, np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest]) + 1)
        inter = w * h
        iou = inter / (areas[i] + areas[rest] - inter)
        suppressed[rest[iou > iou_threshold]] = True
    return np.array(keep, np.int64)
