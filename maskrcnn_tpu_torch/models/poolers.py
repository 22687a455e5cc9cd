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
backward launches one of three kernels of the same file, chosen at the
forward as the JAX package chooses (``backward_choice``):
  * "roi" (default): roi_align_backward, the exact per-sample scatter
    (replacing _roi_align_bwd_roi);
  * "rmw": roi_align_backward_rmw, one block per window of ROIs
    (replacing _roi_align_bwd);
  * "chunk": roi_align_backward_chunk, one block per 8-row chunk of the
    chunk layout (replacing _roi_align_bwd_chunk).
The window backwards consume ``window_layout`` (and ``chunk_layout``),
computed here in plain PyTorch as the JAX package computes ``_precompute``
in jnp. There is no fallback between the kernels and the plain version.
"""

import ctypes
import math
import os

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
    computes. The divisor is filled on the device: a copy from the host
    would wait for the stream."""
    return x / torch.full((), float(d), dtype=x.dtype, device=x.device)


def _const(values, device, dtype=None):
    """A small constant tensor on `device`. torch.tensor(..., device=cuda)
    waits for everything queued on the stream; a non-blocking copy from
    pageable host memory is staged at once and does not."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)


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
    roi_h = _const(hs, dev)[lvl]
    roi_w = _const(ws, dev)[lvl]
    roi_off = _const(offsets, dev)[lvl] + batch_idx.long() * (roi_h * roi_w)
    scale = _const(pcfg.scales, dev, torch.float32)[lvl]

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


# -- window layout of the "rmw" and "chunk" backwards ------------------------

PATCH = 48  # window side in cells: an 8-aligned origin plus 40 cells
CHUNK = 8   # rows of a chunk, and the multiple the sorted rows are padded to
BACKWARDS = ("roi", "rmw", "chunk")


def backward_choice(pcfg):
    """The backward kernel for this pooler: MASKRCNN_POOLER_BWD_P<P>, else
    MASKRCNN_POOLER_BWD, else "roi" (maskrcnn_tpu/models/poolers.py reads
    the same variables). Unlike the JAX package, which runs "rmw" for any
    value it does not know, an unknown value (and "scatter", an XLA path
    with no kernel here) raises."""
    key = "MASKRCNN_POOLER_BWD_P%d" % pcfg.output_size
    name = os.environ.get(key, os.environ.get("MASKRCNN_POOLER_BWD", "roi"))
    if name not in BACKWARDS:
        raise ValueError("ROIAlign backward {!r} (from {} or MASKRCNN_POOLER_BWD): the port "
                         "has {}".format(name, key, ", ".join(BACKWARDS)))
    return name


def _window_weights(coords, mask, p, s):
    """Separable weights of the samples `coords` [R, P*S] (relative to the
    window origin; `mask` false where a sample contributes 0) -> ([R, P,
    PATCH] in-bin sums of the bilinear weights / S, [R] oversize: a sample
    reaches a cell beyond the window). _bin_weights of the TPU kernel
    without its clamp of such samples to the window's last cell."""
    r = coords.shape[0]
    low = torch.floor(coords)
    frac = coords - low
    low = low.long()
    cells = torch.arange(PATCH, device=coords.device)
    w = ((low[..., None] == cells).float() * (1.0 - frac[..., None])
         + (low[..., None] + 1 == cells).float() * frac[..., None])
    w = w * mask[..., None].float()
    w = _true_div(w.reshape(r, p, s, PATCH).sum(dim=2), s)
    oversize = (mask & (low + (frac > 0).long() >= PATCH)).any(dim=1)
    return w, oversize


def window_layout(shapes, boxes, batch_idx, lvl, pcfg):
    """The window-sorted ROI layout of the window backwards: the port of
    _precompute (maskrcnn_tpu/ops/pallas/roi_align_kernel.py:126) without
    its BLOCK slot tables.

    shapes: [(B, Hl, Wl, C)] per level; boxes [R, 4]; batch_idx, lvl [R].
    Each ROI gets a 48 x 48 window of its level at an origin quantized to 8
    and clipped as the TPU kernel's padded level allows (so cells past the
    true edge get zero weight), separable weights over it, and a sort key
    (level, image, y0 / 8, x0 / 8). Returns a dict:
      perm [R]               sorted row -> ROI
      rnew, rwid [Rp]        1 where a window starts; window ordinal
      lvl, b, y0, x0 [Rp]    the window of each sorted row
      roww, colw [Rp, P, 48] weights of each sorted row (zero for padding
                             rows and oversize ROIs)
      oversize [R]           ROIs whose samples reach beyond their window;
                             the kernels scatter them exactly
      rp                     R padded to a multiple of CHUNK; padding rows
                             repeat the last row's window
    On ROIs that fit their window every entry equals _precompute's."""
    p, s = pcfg.output_size, pcfg.sampling_ratio
    dev = boxes.device
    r = boxes.shape[0]
    lvl = lvl.long()
    hs = _const([sh[1] for sh in shapes], dev)[lvl].float()[:, None]
    ws = _const([sh[2] for sh in shapes], dev)[lvl].float()[:, None]
    # the largest origin: TPU levels are padded to >= 48 and a multiple of 8
    top = _const([[max(PATCH, -(-sh[i] // 8) * 8) - PATCH for i in (1, 2)] for sh in shapes],
                 dev)[lvl]
    scale = _const(pcfg.scales, dev, torch.float32)[lvl]

    rois = boxes.float() * scale[:, None]
    rw = torch.clamp(rois[:, 2] - rois[:, 0], min=1.0)
    rh = torch.clamp(rois[:, 3] - rois[:, 1], min=1.0)
    bin_w = _true_div(rw, p)
    bin_h = _true_div(rh, p)
    j = torch.arange(p * s, device=dev)
    ib = (j // s).float()
    sb = (j % s).float()
    ys = rois[:, 1:2] + ib[None] * bin_h[:, None] + (sb[None] + 0.5) * _true_div(bin_h[:, None], s)
    xs = rois[:, 0:1] + ib[None] * bin_w[:, None] + (sb[None] + 0.5) * _true_div(bin_w[:, None], s)
    ymask = (ys >= -1.0) & (ys <= hs)
    xmask = (xs >= -1.0) & (xs <= ws)
    ys = torch.minimum(torch.clamp(ys, min=0.0), hs - 1.0)
    xs = torch.minimum(torch.clamp(xs, min=0.0), ws - 1.0)
    y0 = torch.minimum(torch.floor(ys.amin(dim=1)).long() // 8 * 8, top[:, 0])
    x0 = torch.minimum(torch.floor(xs.amin(dim=1)).long() // 8 * 8, top[:, 1])
    roww, over_y = _window_weights(ys - y0[:, None].float(), ymask, p, s)
    colw, over_x = _window_weights(xs - x0[:, None].float(), xmask, p, s)
    oversize = over_y | over_x
    fits = (~oversize).float()[:, None, None]
    roww, colw = roww * fits, colw * fits

    bidx = batch_idx.long()
    key = ((lvl * shapes[0][0] + bidx) * 1024 + y0 // 8) * 1024 + x0 // 8
    perm = torch.argsort(key, stable=True)
    skey = key[perm]
    rnew = torch.ones_like(skey)
    rnew[1:] = (skey[1:] != skey[:-1]).long()
    pad = (-r) % CHUNK

    def rep(a):
        return torch.cat([a, a[-1:].expand(pad)]) if pad else a

    def zpad(a):
        return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])]) if pad else a

    rnew = torch.cat([rnew, rnew.new_zeros(pad)])
    return dict(
        perm=perm, rnew=rnew, rwid=torch.cumsum(rnew, 0) - 1,
        lvl=rep(lvl[perm]), b=rep(bidx[perm]), y0=rep(y0[perm]), x0=rep(x0[perm]),
        roww=zpad(roww[perm]), colw=zpad(colw[perm]), oversize=oversize, rp=r + pad,
    )


def chunk_layout(layout):
    """The chunk backward's rows: the port of _chunk_layout
    (roi_align_kernel.py:663) with q = CHUNK. Each window's run of sorted
    rows is padded to a multiple of q while a budget of rp / 2 padding rows
    lasts, so that most q-row chunks hold one window only. Returns src [n]
    (the sorted row of each chunk row; padding rows repeat their window's
    last one), real [n] (false for padding), rnew [n] (1 where a window
    starts), pure [n / q] (1 for a chunk of one window) and n."""
    rwid, rnew, rp = layout["rwid"], layout["rnew"], layout["rp"]
    q = CHUNK
    dev = rwid.device
    budget = -(-(rp // 2) // q) * q
    n = rp + budget
    rows = torch.arange(rp, device=dev)
    count = torch.zeros(rp, dtype=torch.long, device=dev).index_add_(
        0, rwid, torch.ones_like(rwid))  # CUDA bincount reads its max back to the host
    want = (-count) % q
    allowed = torch.where(torch.cumsum(want, 0) <= budget, want, 0)
    before = torch.cumsum(allowed, 0) - allowed
    pos = rows + before[rwid]
    hit = torch.full((n,), -1, dtype=torch.long, device=dev).scatter_(0, pos, rows)
    src = torch.cummax(hit, 0).values.clamp(min=0)
    rnew_c = torch.zeros(n, dtype=torch.long, device=dev).scatter_(0, pos, rnew)
    pure = 1 - rnew_c.reshape(-1, q)[:, 1:].amax(dim=1)
    return dict(src=src, real=hit >= 0, rnew=rnew_c, pure=pure, n=n)


def window_kernel_inputs(kind, shapes, boxes, batch_idx, lvl, pcfg):
    """The window layout as the "rmw" or "chunk" kernel reads it: rows
    [5, rp] int32 (ROI, or -1 for padding rows and oversize ROIs; level,
    image, y0, x0), weights [2, rp, P, 48] float32 (roww, colw), oversize
    [R] uint8; with wstart [rp + 2] int32 for "rmw" (first row of each
    window, then rp) or crow [3, n] int32 (src, real, rnew) for "chunk".
    Also returns the layout dicts under "layout" and "chunks"."""
    lay = window_layout(shapes, boxes, batch_idx, lvl, pcfg)
    rp, r, dev = lay["rp"], boxes.shape[0], boxes.device
    roi = torch.full((rp,), -1, dtype=torch.long, device=dev)
    roi[:r] = torch.where(lay["oversize"][lay["perm"]], -1, lay["perm"])
    out = {
        "layout": lay,
        "rows": torch.stack([roi, lay["lvl"], lay["b"], lay["y0"], lay["x0"]]).int().contiguous(),
        "weights": torch.stack([lay["roww"], lay["colw"]]).contiguous(),
        "oversize": lay["oversize"].to(torch.uint8).contiguous(),
    }
    if kind == "rmw":
        wstart = torch.full((rp + 2,), rp, dtype=torch.int32, device=dev)
        slot = torch.where(lay["rnew"] == 1, lay["rwid"], rp + 1)  # rp + 1: a spare slot
        out["wstart"] = wstart.scatter_(0, slot, torch.arange(rp, dtype=torch.int32, device=dev))
    else:
        ch = chunk_layout(lay)
        out["chunks"] = ch
        out["crow"] = torch.stack([ch["src"], ch["real"].long(), ch["rnew"]]).int().contiguous()
    return out


# -- CUDA kernels ---------------------------------------------------------------

_I, _P, _LL = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
# roi_align_backward's arguments, which the window backwards begin with
_BWD_ARGS = [_P, _P, _LL, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P]


def _lib():
    lib = native.load("roi_align")
    if not getattr(lib, "_typed", False):
        lib.roi_align_forward.argtypes = [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                                          _P, _P]
        lib.roi_align_backward.argtypes = _BWD_ARGS + [_P]
        lib.roi_align_backward_rmw.argtypes = _BWD_ARGS + [_P, _I, _P, _P, _P, _P]
        lib.roi_align_backward_chunk.argtypes = _BWD_ARGS + [_P, _I, _P, _P, _I, _I, _P, _P]
        for fn in (lib.roi_align_forward, lib.roi_align_backward, lib.roi_align_backward_rmw,
                   lib.roi_align_backward_chunk, lib.roi_align_max_levels,
                   lib.roi_align_window_max_p):
            fn.restype = ctypes.c_int
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


def _backward_args(shapes, boxes, bidx, lvl, pcfg, dout, acc, out):
    """The leading arguments every backward entry point takes."""
    num_levels = len(shapes)
    offsets, off = [], 0
    for shape in shapes:
        offsets.append(off)
        off += math.prod(shape)
    r, p, c = dout.shape[0], dout.shape[1], dout.shape[3]
    return [
        acc.data_ptr(), (ctypes.c_longlong * num_levels)(*offsets), off,
        (ctypes.c_int * num_levels)(*[shape[1] for shape in shapes]),
        (ctypes.c_int * num_levels)(*[shape[2] for shape in shapes]),
        (ctypes.c_float * num_levels)(*pcfg.scales), num_levels, boxes.data_ptr(),
        bidx.data_ptr(), lvl.data_ptr(), r, c, p, pcfg.sampling_ratio,
        _DTYPE_CODES[dout.dtype], dout.data_ptr(), out.data_ptr(),
    ]


def launch_backward(shapes, boxes, bidx, lvl, pcfg, dout, acc, out, kind="roi", inputs=None):
    """A backward kernel alone, on prepared buffers: level shapes [(B, Hl,
    Wl, C)], boxes [R, 4] f32, batch_idx and level [R] int32, dout
    [R, P, P, C] contiguous; acc a float32 buffer of sum(B*Hl*Wl*C)
    elements (zeroed by the kernel), out a buffer of the same size in
    dout's dtype (unused for float32, where acc is the gradient). `kind`
    names the backward; "rmw" and "chunk" take `inputs` from
    window_kernel_inputs. Launches on the current stream."""
    args = _backward_args(shapes, boxes, bidx, lvl, pcfg, dout, acc, out)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    lib = _lib()
    if kind == "roi":
        rc = lib.roi_align_backward(*args, stream)
    else:
        common = [inputs["oversize"].data_ptr(), inputs["rows"].shape[1],
                  inputs["rows"].data_ptr(), inputs["weights"].data_ptr()]
        if kind == "rmw":
            rc = lib.roi_align_backward_rmw(*args, *common, inputs["wstart"].data_ptr(), stream)
        else:
            crow = inputs["crow"]
            rc = lib.roi_align_backward_chunk(*args, *common, crow.shape[1], CHUNK,
                                              crow.data_ptr(), stream)
    native.check(rc, "roi_align_backward ({})".format(kind))


def _backward(kind, dout, shapes, boxes, bidx, lvl, pcfg):
    if dout.dtype not in _DTYPE_CODES:
        raise TypeError("roi_align backward takes float32 or bfloat16 gradients")
    if kind != "roi" and pcfg.output_size > _lib().roi_align_window_max_p():
        raise ValueError("the window backwards take P <= {}".format(
            _lib().roi_align_window_max_p()))
    dout = dout.contiguous()
    inputs = None if kind == "roi" else window_kernel_inputs(kind, shapes, boxes, bidx, lvl, pcfg)
    sizes = [math.prod(shape) for shape in shapes]
    acc = torch.empty((sum(sizes),), dtype=torch.float32, device=dout.device)
    out = acc if dout.dtype == torch.float32 else torch.empty_like(acc, dtype=dout.dtype)
    launch_backward(shapes, boxes, bidx, lvl, pcfg, dout, acc, out, kind, inputs)
    return [g.view(shape) for g, shape in zip(out.split(sizes), shapes)]


def roi_align_backward(dout, shapes, boxes, bidx, lvl, pcfg):
    """d features of the kernel's forward by the "roi" backward: dout
    [R, P, P, C] (float32 or bfloat16, CUDA) -> one NHWC-contiguous
    [B, Hl, Wl, C] gradient per level in dout's dtype, summed in float32
    and rounded once."""
    grads = _backward("roi", dout, shapes, boxes, bidx, lvl, pcfg)
    roi_align_backward.launches += 1
    return grads


def roi_align_backward_rmw(dout, shapes, boxes, bidx, lvl, pcfg):
    """The same gradient by the "rmw" backward (one block per window)."""
    grads = _backward("rmw", dout, shapes, boxes, bidx, lvl, pcfg)
    roi_align_backward_rmw.launches += 1
    return grads


def roi_align_backward_chunk(dout, shapes, boxes, bidx, lvl, pcfg):
    """The same gradient by the "chunk" backward (one block per chunk)."""
    grads = _backward("chunk", dout, shapes, boxes, bidx, lvl, pcfg)
    roi_align_backward_chunk.launches += 1
    return grads


roi_align_backward.launches = 0
roi_align_backward_rmw.launches = 0
roi_align_backward_chunk.launches = 0
BACKWARD_KERNELS = {"roi": roi_align_backward, "rmw": roi_align_backward_rmw,
                    "chunk": roi_align_backward_chunk}


class RoIAlignFunction(torch.autograd.Function):
    """The kernel's forward with a backward kernel as its gradient: the one
    named at the forward (``backward_choice``), as JAX fixes its choice when
    it traces. Saves boxes, image indices, levels and the level shapes, not
    the features. The boxes and image indices get no gradient (the JAX
    vjp's float0)."""

    @staticmethod
    def forward(ctx, pcfg, bwd, boxes, bidx, lvl, *features):
        r, p, c = boxes.shape[0], pcfg.output_size, features[0].shape[3]
        out = torch.empty((r, p, p, c), dtype=features[0].dtype, device=boxes.device)
        if r > 0:
            launch(features, boxes, bidx, lvl, pcfg, out)
            multilevel_roi_align.launches += 1
        ctx.pcfg = pcfg
        ctx.bwd = bwd
        ctx.shapes = [tuple(f.shape) for f in features]
        ctx.save_for_backward(boxes, bidx, lvl)
        return out

    @staticmethod
    def backward(ctx, dout):
        boxes, bidx, lvl = ctx.saved_tensors
        grads = BACKWARD_KERNELS[ctx.bwd](dout, ctx.shapes, boxes, bidx, lvl, ctx.pcfg)
        return (None, None, None, None, None, *grads)


def _roi_align_cuda(features, boxes, batch_idx, pcfg, bwd):
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
    return RoIAlignFunction.apply(pcfg, bwd, boxes, bidx, lvl, *features)


def multilevel_roi_align(features, boxes, batch_idx, pcfg):
    """Pool each ROI from its assigned level. features: list of NHWC
    [B, Hl, Wl, C], one per scale; boxes [R, 4]; batch_idx [R] ->
    [R, P, P, C] in the features' dtype. The backward kernel is read from
    the environment here (``backward_choice``) on every device; CPU
    tensors take the plain version and its autograd whatever it names."""
    if len(features) != len(pcfg.scales):
        raise ValueError("one feature map per pooler scale")
    bwd = backward_choice(pcfg)
    if boxes.device.type == "cpu":
        return multilevel_roi_align_plain(features, boxes, batch_idx, pcfg)
    if boxes.device.type != "cuda":
        raise ValueError("roi_align runs on cpu or cuda tensors, not {}".format(boxes.device))
    return _roi_align_cuda(features, boxes, batch_idx, pcfg, bwd)


multilevel_roi_align.launches = 0
