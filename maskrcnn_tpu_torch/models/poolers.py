"""Multi-level ROIAlign pooler (FPN).

PyTorch counterpart of maskrcnn_tpu/models/poolers.py for the fixed
sampling-ratio FPN case. Each ROI is pooled from the pyramid level that
``assign_levels`` gives it (FPN paper eqn. 1).

``multilevel_roi_align`` is the wrapper the heads call: on CPU tensors it
runs the plain version ``multilevel_roi_align_plain`` (a port of the exact
gather path ``_pool_roi_block``), and autograd differentiates it; on CUDA
tensors it goes through ``RoIAlignFunction``, whose forward launches the
hand-written kernel csrc/roi_align.cu:roi_align_forward (replacing the TPU
kernel ops/pallas/roi_align_kernel.py:multilevel_roi_align_pallas) and whose
backward launches roi_align_backward from the same file (replacing the
default "roi" backward _roi_align_bwd_roi). There is no fallback between
the kernels and the plain version.
"""

import ctypes
import math

import torch

from ..ops import native
from ..ops.box_ops import TO_REMOVE


class PoolerConfig:
    # FPN paper eqn. 1: a 224 x 224 ROI maps to level 4
    canonical_scale = 224
    canonical_level = 4

    def __init__(self, output_size, scales, sampling_ratio):
        if int(sampling_ratio) <= 0:
            raise NotImplementedError(
                "adaptive sampling (ratio 0, the C4 heads) is not ported yet")
        self.output_size = int(output_size)
        self.scales = tuple(scales)
        self.sampling_ratio = int(sampling_ratio)
        self.k_min = -int(math.log2(self.scales[0]))
        self.k_max = -int(math.log2(self.scales[-1]))


def _true_div(x, d):
    """x / d rounded as IEEE division. PyTorch's CUDA division by a Python
    number multiplies by its reciprocal, which can round differently; a
    device tensor divisor keeps the true quotient the kernel (and JAX)
    computes."""
    return x / torch.tensor(float(d), dtype=x.dtype, device=x.device)


def assign_levels(boxes, pcfg):
    """0-based pyramid level per ROI, [R] int32."""
    area = torch.clamp(boxes[..., 2] - boxes[..., 0] + TO_REMOVE, min=0) * torch.clamp(
        boxes[..., 3] - boxes[..., 1] + TO_REMOVE, min=0
    )
    s = torch.sqrt(area)
    target = torch.floor(
        pcfg.canonical_level + torch.log2(_true_div(s, pcfg.canonical_scale) + 1e-6)
    )
    target = torch.clamp(target, pcfg.k_min, pcfg.k_max)
    return (target - pcfg.k_min).to(torch.int32)


def sample_corners(level_shapes, boxes, batch_idx, pcfg):
    """Bilinear sample corners of the gather path.

    level_shapes: [(B, Hl, Wl)] per level; boxes [R, 4] image coords;
    batch_idx [R]. Returns (index, weight, outside): index [4, R, PS, PS]
    rows of the levels flattened and concatenated into one
    [sum_l B*Hl*Wl, C] buffer, weight [4, R, PS, PS] float32, and outside
    [R, PS, PS] for samples that contribute 0 (PS = P * sampling ratio)."""
    p, s = pcfg.output_size, pcfg.sampling_ratio
    dev = boxes.device
    r = boxes.shape[0]
    hs = [shape[1] for shape in level_shapes]
    ws = [shape[2] for shape in level_shapes]
    offsets, off = [], 0
    for bl, hl, wl in level_shapes:
        offsets.append(off)
        off += bl * hl * wl

    lvl = assign_levels(boxes, pcfg).long() if len(level_shapes) > 1 else \
        torch.zeros((r,), dtype=torch.long, device=dev)
    roi_h = torch.tensor(hs, device=dev)[lvl]
    roi_w = torch.tensor(ws, device=dev)[lvl]
    roi_off = torch.tensor(offsets, device=dev)[lvl] + batch_idx.long() * (roi_h * roi_w)
    scale = torch.tensor(pcfg.scales, dtype=torch.float32, device=dev)[lvl]

    rois = boxes.float() * scale[:, None]
    rw = torch.clamp(rois[:, 2] - rois[:, 0], min=1.0)
    rh = torch.clamp(rois[:, 3] - rois[:, 1], min=1.0)
    bin_w = _true_div(rw, p)
    bin_h = _true_div(rh, p)
    j = torch.arange(p * s, device=dev)
    ib = (j // s).float()
    sb = (j % s).float()
    ys = rois[:, 1:2] + ib[None, :] * bin_h[:, None] + (sb[None, :] + 0.5) * _true_div(bin_h[:, None], s)
    xs = rois[:, 0:1] + ib[None, :] * bin_w[:, None] + (sb[None, :] + 0.5) * _true_div(bin_w[:, None], s)

    y = ys[:, :, None].expand(r, p * s, p * s)
    x = xs[:, None, :].expand(r, p * s, p * s)
    h_f = roi_h.float()[:, None, None]
    w_f = roi_w.float()[:, None, None]
    outside = (y < -1.0) | (y > h_f) | (x < -1.0) | (x > w_f)
    y = y.clamp(min=0.0)
    x = x.clamp(min=0.0)
    h_i = roi_h[:, None, None]
    w_i = roi_w[:, None, None]
    y_low = torch.minimum(y.long(), h_i - 1)
    x_low = torch.minimum(x.long(), w_i - 1)
    y_high = torch.minimum(y_low + 1, h_i - 1)
    x_high = torch.minimum(x_low + 1, w_i - 1)
    y = torch.where(y_low >= h_i - 1, y_low.float(), y)
    x = torch.where(x_low >= w_i - 1, x_low.float(), x)
    ly = y - y_low
    lx = x - x_low
    hy = 1.0 - ly
    hx = 1.0 - lx
    base = roi_off[:, None, None]
    index = torch.stack([
        base + y_low * w_i + x_low, base + y_low * w_i + x_high,
        base + y_high * w_i + x_low, base + y_high * w_i + x_high,
    ])
    weight = torch.stack([hy * hx, hy * lx, ly * hx, ly * lx])
    return index, weight, outside


def multilevel_roi_align_plain(features, boxes, batch_idx, pcfg):
    """features: list of [B, Hl, Wl, C] (NHWC), boxes [R, 4] f32 image
    coords, batch_idx [R] int -> [R, P, P, C] in the features' dtype.

    The gather path of the JAX pooler: every level flattened into one
    [sum_l B*Hl*Wl, C] buffer, four bilinear corner gathers per sample,
    S x S samples averaged per bin, arithmetic in the features' dtype."""
    p, s = pcfg.output_size, pcfg.sampling_ratio
    dtype = features[0].dtype
    c = features[0].shape[-1]
    r = boxes.shape[0]
    flat = torch.cat([f.reshape(-1, c) for f in features], dim=0)
    index, weight, outside = sample_corners(
        [f.shape[:3] for f in features], boxes, batch_idx, pcfg)
    w = weight[..., None].to(dtype)
    val = (w[0] * flat[index[0]] + w[1] * flat[index[1]]
           + w[2] * flat[index[2]] + w[3] * flat[index[3]])
    val = torch.where(outside[..., None], torch.zeros((), dtype=dtype, device=boxes.device), val)
    return val.reshape(r, p, s, p, s, c).mean(dim=(2, 4))


def _lib():
    lib = native.load("roi_align")
    if not getattr(lib, "_typed", False):
        lib.roi_align_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.roi_align_forward.restype = ctypes.c_int
        lib.roi_align_backward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.roi_align_backward.restype = ctypes.c_int
        lib.roi_align_max_levels.restype = ctypes.c_int
        lib._typed = True
    return lib


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def launch(features, boxes, bidx, lvl, pcfg, out):
    """The kernel alone, on prepared buffers: NHWC-contiguous levels, boxes
    [R, 4] f32, batch_idx and level [R] int32 in, out [R, P, P, C] in the
    features' dtype. Launches on the current stream."""
    num_levels = len(features)
    ptrs = (ctypes.c_void_p * num_levels)(*[f.data_ptr() for f in features])
    hs = (ctypes.c_int * num_levels)(*[f.shape[1] for f in features])
    ws = (ctypes.c_int * num_levels)(*[f.shape[2] for f in features])
    scales = (ctypes.c_float * num_levels)(*pcfg.scales)
    r, p, c = out.shape[0], out.shape[1], out.shape[3]
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    rc = _lib().roi_align_forward(
        ptrs, hs, ws, scales, num_levels, boxes.data_ptr(), bidx.data_ptr(),
        lvl.data_ptr(), r, c, p, pcfg.sampling_ratio, _DTYPE_CODES[out.dtype],
        out.data_ptr(), stream,
    )
    native.check(rc, "roi_align")


def launch_backward(shapes, boxes, bidx, lvl, pcfg, dout, acc, out):
    """The backward kernel alone, on prepared buffers: level shapes [(B, Hl,
    Wl, C)], boxes [R, 4] f32, batch_idx and level [R] int32, dout
    [R, P, P, C] contiguous; acc a float32 buffer of sum(B*Hl*Wl*C)
    elements (zeroed by the kernel), out a buffer of the same size in
    dout's dtype (unused for float32, where acc is the gradient). Launches
    on the current stream."""
    num_levels = len(shapes)
    offsets, off = [], 0
    for shape in shapes:
        offsets.append(off)
        off += math.prod(shape)
    offs = (ctypes.c_longlong * num_levels)(*offsets)
    hs = (ctypes.c_int * num_levels)(*[shape[1] for shape in shapes])
    ws = (ctypes.c_int * num_levels)(*[shape[2] for shape in shapes])
    scales = (ctypes.c_float * num_levels)(*pcfg.scales)
    r, p, c = dout.shape[0], dout.shape[1], dout.shape[3]
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    rc = _lib().roi_align_backward(
        acc.data_ptr(), offs, off, hs, ws, scales, num_levels, boxes.data_ptr(),
        bidx.data_ptr(), lvl.data_ptr(), r, c, p, pcfg.sampling_ratio,
        _DTYPE_CODES[dout.dtype], dout.data_ptr(), out.data_ptr(), stream,
    )
    native.check(rc, "roi_align_backward")


def roi_align_backward(dout, shapes, boxes, bidx, lvl, pcfg):
    """d features of the kernel's forward: dout [R, P, P, C] (float32 or
    bfloat16, CUDA) -> one NHWC-contiguous [B, Hl, Wl, C] gradient per
    level in dout's dtype, summed in float32 and rounded once."""
    if dout.dtype not in _DTYPE_CODES:
        raise TypeError("roi_align backward takes float32 or bfloat16 gradients")
    dout = dout.contiguous()
    sizes = [math.prod(shape) for shape in shapes]
    acc = torch.empty((sum(sizes),), dtype=torch.float32, device=dout.device)
    out = acc if dout.dtype == torch.float32 else torch.empty_like(acc, dtype=dout.dtype)
    launch_backward(shapes, boxes, bidx, lvl, pcfg, dout, acc, out)
    roi_align_backward.launches += 1
    return [g.view(shape) for g, shape in zip(out.split(sizes), shapes)]


roi_align_backward.launches = 0


class RoIAlignFunction(torch.autograd.Function):
    """The kernel's forward with the backward kernel as its gradient. Saves
    boxes, image indices, levels and the level shapes, not the features.
    The boxes and image indices get no gradient (the JAX vjp's float0)."""

    @staticmethod
    def forward(ctx, pcfg, boxes, bidx, lvl, *features):
        r, p, c = boxes.shape[0], pcfg.output_size, features[0].shape[3]
        out = torch.empty((r, p, p, c), dtype=features[0].dtype, device=boxes.device)
        if r > 0:
            launch(features, boxes, bidx, lvl, pcfg, out)
            multilevel_roi_align.launches += 1
        ctx.pcfg = pcfg
        ctx.shapes = [tuple(f.shape) for f in features]
        ctx.save_for_backward(boxes, bidx, lvl)
        return out

    @staticmethod
    def backward(ctx, dout):
        boxes, bidx, lvl = ctx.saved_tensors
        grads = roi_align_backward(dout, ctx.shapes, boxes, bidx, lvl, ctx.pcfg)
        return (None, None, None, None, *grads)


def _roi_align_cuda(features, boxes, batch_idx, pcfg):
    dtype = features[0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError("roi_align kernel takes float32 or bfloat16 features")
    b, _, _, c = features[0].shape
    for f in features:
        if f.device != boxes.device or f.dtype != dtype or f.shape[0] != b or f.shape[3] != c:
            raise ValueError("pyramid levels must share device, dtype, batch and channels")
        if not f.is_contiguous():
            raise ValueError("roi_align kernel takes NHWC-contiguous levels "
                             "(channels_last NCHW maps, permuted)")
    if boxes.dtype != torch.float32 or boxes.ndim != 2 or boxes.shape[1] != 4:
        raise ValueError("boxes must be [R, 4] float32")
    if len(features) > _lib().roi_align_max_levels():
        raise ValueError("roi_align kernel takes at most {} levels"
                         .format(_lib().roi_align_max_levels()))
    boxes = boxes.detach().contiguous()
    bidx = batch_idx.to(torch.int32).contiguous()
    if len(features) > 1:
        lvl = assign_levels(boxes, pcfg).contiguous()
    else:
        lvl = torch.zeros_like(bidx)
    return RoIAlignFunction.apply(pcfg, boxes, bidx, lvl, *features)


def multilevel_roi_align(features, boxes, batch_idx, pcfg):
    """Pool each ROI from its assigned level. features: list of NHWC
    [B, Hl, Wl, C], one per scale; boxes [R, 4]; batch_idx [R] ->
    [R, P, P, C] in the features' dtype."""
    if len(features) != len(pcfg.scales):
        raise ValueError("one feature map per pooler scale")
    if boxes.device.type == "cpu":
        return multilevel_roi_align_plain(features, boxes, batch_idx, pcfg)
    if boxes.device.type != "cuda":
        raise ValueError("roi_align runs on cpu or cuda tensors, not {}".format(boxes.device))
    return _roi_align_cuda(features, boxes, batch_idx, pcfg)


multilevel_roi_align.launches = 0
