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
  * "roi" (default): roi_align_backward, one block per 8 x 8 cell tile of
    the gradient gathering the ROIs that meet it (replacing
    _roi_align_bwd_roi); ``roi_tile_inputs`` sorts its ROI lists, and
    ``tile_owner_gradient`` is its decomposition in plain PyTorch;
  * "rmw" and "chunk": roi_align_backward_rmw / _chunk, the same tile
    blocks taking their ROIs from the window index of the TPU kernels'
    layout, by sorted rows or by chunk rows (replacing _roi_align_bwd and
    _roi_align_bwd_chunk); ``window_kernel_inputs`` builds the index on the
    device, and ``window_tile_gradient`` is their decomposition in plain
    PyTorch.
``window_layout`` and ``chunk_layout`` port the JAX package's
``_precompute`` and ``_chunk_layout`` (the window sort, its weights and
the chunk rows), which the index shares. The kernels take NHWC levels with
C % 8 == 0 and 16-byte aligned buffers, and the wrappers raise on anything
else. There is no fallback between the kernels and the plain version.

Adaptive sampling (POOLER_SAMPLING_RATIO 0, the C4 and FBNet heads): a bin
takes n = clip(ceil(bin), 1, s) samples an axis from a static superset of s,
sample k weighing 1/n when k < n (``adaptive_axis_samples``). On one level s
is the map's own bound, min(8, max(ceil(H / P), ceil(W / P), 1)), exact
because the ROIs are clipped to the image (``adaptive_cap``). On CUDA tensors it takes
the same two kernels as the fixed grid, their adaptive instances (each ROI's
own n, the weights 1/n), with the "roi" backward whatever
MASKRCNN_POOLER_BWD names: the window backwards take the fixed grid only.
On CPU tensors it is the JAX package's plain tensor code
(``adaptive_roi_align``): the ROIs of image-major blocks of
``rois_per_image`` on one level pool as two products against the whole map
(``c4_matmul_pool``), other ROIs by the gather path in ROI chunks.

Spans (utils/profiling.py:span): ``multilevel_roi_align`` runs in
"roi_pool", and the kernels' backward (``RoIAlignFunction.backward``, on
the autograd engine's thread) in "roi_pool.bwd". The plain path's backward
on CPU tensors is autograd's: it has no span of its own and reads under the
train step's "backward".
"""

import ctypes
import itertools
import math
import os

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import native
from ..ops.box_ops import TO_REMOVE
from ..utils.profiling import span


class PoolerConfig:
    # FPN paper eqn. 1: a 224 x 224 ROI maps to level 4
    canonical_scale = 224
    canonical_level = 4

    # ratio 0: the reference's adaptive ceil(roi / bin) samples a bin, exact
    # up to this many an axis (adaptive_roi_align)
    adaptive_max = 8

    def __init__(self, output_size, scales, sampling_ratio):
        self.output_size = int(output_size)
        self.scales = tuple(scales)
        self.adaptive = int(sampling_ratio) <= 0
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
    r = boxes.shape[0]
    lvl = assign_levels(boxes, pcfg).long() if len(level_shapes) > 1 else \
        torch.zeros((r,), dtype=torch.long, device=boxes.device)
    ys, xs = _sample_coords(boxes, lvl, pcfg)
    return _corners(level_shapes, batch_idx, lvl, ys, xs)


def _corners(level_shapes, batch_idx, lvl, ys, xs):
    """The gather path's corners of the samples at rows ys [R, Sy] and
    columns xs [R, Sx] of each ROI's level lvl [R]: (index, weight,
    outside) as sample_corners gives them, [.., R, Sy, Sx]."""
    dev = ys.device
    r, ny, nx = ys.shape[0], ys.shape[1], xs.shape[1]
    hs = [shape[1] for shape in level_shapes]
    ws = [shape[2] for shape in level_shapes]
    offsets, off = [], 0
    for shape in level_shapes:
        offsets.append(off)
        off += shape[0] * shape[1] * shape[2]
    lvl = lvl.long()
    roi_h = _const(hs, dev)[lvl]
    roi_w = _const(ws, dev)[lvl]
    roi_off = _const(offsets, dev)[lvl] + batch_idx.long() * (roi_h * roi_w)

    y = ys[:, :, None].expand(r, ny, nx)
    x = xs[:, None, :].expand(r, ny, nx)
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


# -- adaptive sampling: its grid, and the plain paths (the JAX package's XLA paths) --

# the gather path pools the ROIs in chunks, and the matmul path its ROI
# blocks, once the samples (or the [B, K, P, W, C] product) of one call
# would pass this (the JAX package's _CHUNK_THRESHOLD_BYTES); in training
# each chunk is recomputed in the backward pass, as jax.checkpoint does
CHUNK_BYTES = 1 << 29


def adaptive_axis_samples(origin, bin_sz, p, s_max):
    """Sample positions and weights along one axis of the adaptive grid
    (JAX ops/roi_align.py:adaptive_axis_samples): origin, bin_sz [R] ->
    pos, wt [R, P * s_max]; sample k of a bin at (k + 0.5) * bin / n with
    weight 1 / n when k < n = clip(ceil(bin), 1, s_max), else 0."""
    n = torch.clamp(torch.ceil(bin_sz), 1.0, float(s_max))
    j = torch.arange(p * s_max, device=origin.device)
    binidx = (j // s_max).float()
    k = (j % s_max).float()
    pos = origin[:, None] + binidx[None] * bin_sz[:, None] + (k[None] + 0.5) * (
        bin_sz[:, None] / n[:, None])
    wt = (k[None] < n[:, None]).float() / n[:, None]
    return pos, wt


def adaptive_cap(pcfg, level_shapes):
    """s of the adaptive grid: its most samples a bin an axis. On one level
    the map's own bound, min(adaptive_max, max(ceil(H / P), ceil(W / P),
    1)); on several, adaptive_max. level_shapes: [(B, Hl, Wl, ...)]."""
    s = pcfg.adaptive_max
    if len(level_shapes) == 1:
        p, h, w = pcfg.output_size, level_shapes[0][1], level_shapes[0][2]
        s = min(s, max(-(-h // p), -(-w // p), 1))
    return s


def _adaptive_axes(boxes, lvl, pcfg, s):
    """Each ROI's adaptive sample rows and columns on its level: (ys, wy,
    xs, wx), [R, P * s] each."""
    p = pcfg.output_size
    rois, rw, rh = _level_rois(boxes, lvl, pcfg)
    ys, wy = adaptive_axis_samples(rois[:, 1], _true_div(rh, p), p, s)
    xs, wx = adaptive_axis_samples(rois[:, 0], _true_div(rw, p), p, s)
    return ys, wy, xs, wx


def _adaptive_gather(flat, level_shapes, boxes, batch_idx, pcfg, s):
    """The gather path of the adaptive grid on one block of ROIs (JAX
    poolers._pool_roi_block): flat [sum_l B*Hl*Wl, C] -> [R, P, P, C] in
    flat's dtype, each sample weighted by wy * wx and the bin summed."""
    p, dtype, c = pcfg.output_size, flat.dtype, flat.shape[-1]
    r = boxes.shape[0]
    lvl = assign_levels(boxes, pcfg) if len(level_shapes) > 1 else \
        torch.zeros((r,), dtype=torch.int32, device=boxes.device)
    ys, wy, xs, wx = _adaptive_axes(boxes, lvl, pcfg, s)
    index, weight, outside = _corners(level_shapes, batch_idx, lvl, ys, xs)
    w = weight[..., None].to(dtype)
    val = (w[0] * flat[index[0]] + w[1] * flat[index[1]]
           + w[2] * flat[index[2]] + w[3] * flat[index[3]])
    val = torch.where(outside[..., None], torch.zeros((), dtype=dtype, device=flat.device), val)
    wgt = (wy[:, :, None] * wx[:, None, :]).to(dtype)
    return (val * wgt[..., None]).reshape(r, p, s, p, s, c).sum(dim=(2, 4))


def _dense_axis_weights(coords, w, size, p, s):
    """[R, P, size]: the summed weight of each cell of an axis of `size`
    in each output bin, from the adaptive samples coords, w [R, P * s], by
    the gather path's per-sample rules (outside [-1, size] zero, the
    bilinear split over the floor cell and the next, the snap at the last
    cell): JAX poolers._dense_axis_weights."""
    r = coords.shape[0]
    outside = (coords < -1.0) | (coords > float(size))
    y = coords.clamp(min=0.0)
    y_low = torch.clamp(y.long(), max=size - 1)
    y_high = torch.clamp(y_low + 1, max=size - 1)
    y = torch.where(y_low >= size - 1, y_low.float(), y)
    ly = y - y_low
    hy = 1.0 - ly
    w_eff = torch.where(outside, torch.zeros_like(w), w)
    cells = torch.arange(size, device=coords.device)
    dense = ((w_eff * hy)[:, :, None] * (cells == y_low[:, :, None])
             + (w_eff * ly)[:, :, None] * (cells == y_high[:, :, None]))
    return dense.reshape(r, p, s, size).sum(dim=2)


def c4_matmul_pool(feature, boxes, pcfg, k_per_image, s):
    """Single-level adaptive ROIAlign as two products against the whole
    map (JAX poolers._c4_matmul_pool): with RowW [R, P, H] and ColW
    [R, P, W] the dense bin weights of each axis in the map's dtype,
    A = RowW . F per image, then out = ColW . A. feature [B, H, W, C]
    (NHWC), boxes [B * k_per_image, 4] in image-major blocks -> [R, P, P, C]
    in the feature's dtype (each product accumulated in float32 and rounded
    once). The blocks are cut into chunks of kc ROIs an image, kc the
    largest divisor of k_per_image whose [B, kc, P, W, C] product stays
    under CHUNK_BYTES / 2."""
    b, h, w, c = feature.shape
    p, dtype = pcfg.output_size, feature.dtype
    r = boxes.shape[0]
    if r != b * k_per_image:
        raise ValueError("the matmul pooler takes {} x {} ROIs, not {}".format(
            b, k_per_image, r))
    lvl = torch.zeros((r,), dtype=torch.int32, device=boxes.device)
    ys, wy, xs, wx = _adaptive_axes(boxes, lvl, pcfg, s)
    roww = _dense_axis_weights(ys, wy, h, p, s).to(dtype).reshape(b, k_per_image, p, h)
    colw = _dense_axis_weights(xs, wx, w, p, s).to(dtype).reshape(b, k_per_image, p, w)
    per_roi = b * p * w * c * feature.element_size()
    kc = max(1, min(k_per_image, (CHUNK_BYTES // 2) // per_roi))
    while k_per_image % kc:
        kc -= 1
    f2 = feature.reshape(b, h, w * c)

    def body(wr, wc, f):
        a = torch.bmm(wr.reshape(b, kc * p, h), f).reshape(b, kc, p, w, c)
        # [B, kc, Pi, Pj, C], made contiguous: einsum returns a view with Pi
        # and Pj swapped in memory, and PyTorch's CPU convolution computes
        # a wrong input gradient on NHWC maps of such strides (2.5e-2 of
        # its max off at the res5 head, tests/test_torch_c4.py)
        return torch.einsum("bkjw,bkiwc->bkijc", wc, a).contiguous()

    if kc == k_per_image:
        out = body(roww, colw, f2)
    else:
        remat = torch.is_grad_enabled() and f2.requires_grad
        out = torch.cat([
            checkpoint(body, roww[:, i:i + kc], colw[:, i:i + kc], f2, use_reentrant=False)
            if remat else body(roww[:, i:i + kc], colw[:, i:i + kc], f2)
            for i in range(0, k_per_image, kc)], dim=1)
    return out.reshape(r, p, p, c)


def adaptive_roi_align(features, boxes, batch_idx, pcfg, rois_per_image=None):
    """ROIAlign at POOLER_SAMPLING_RATIO 0 in plain tensor code (the JAX
    package's gather and matmul paths; what ``multilevel_roi_align`` runs
    on CPU tensors). features: NHWC [B, Hl, Wl, C] per scale; boxes [R, 4];
    rois_per_image: K when the boxes are image-major blocks of K, which on
    one level takes c4_matmul_pool. -> [R, P, P, C] in the features'
    dtype."""
    p = pcfg.output_size
    s = adaptive_cap(pcfg, [f.shape for f in features])
    if len(features) == 1:
        if rois_per_image and boxes.shape[0] == features[0].shape[0] * rois_per_image:
            return c4_matmul_pool(features[0], boxes, pcfg, rois_per_image, s)
    c = features[0].shape[-1]
    shapes = [tuple(f.shape) for f in features]
    flat = torch.cat([f.reshape(-1, c) for f in features], dim=0)
    r = boxes.shape[0]
    bytes_per_roi = (p * s) ** 2 * c * flat.element_size()
    if r * bytes_per_roi <= CHUNK_BYTES:
        return _adaptive_gather(flat, shapes, boxes, batch_idx, pcfg, s)
    chunk = max(1, CHUNK_BYTES // (2 * bytes_per_roi))
    chunk = 1 << (chunk.bit_length() - 1)
    remat = torch.is_grad_enabled() and flat.requires_grad
    outs = []
    for i in range(0, r, chunk):
        args = (flat, shapes, boxes[i:i + chunk], batch_idx[i:i + chunk], pcfg, s)
        outs.append(checkpoint(_adaptive_gather, *args, use_reentrant=False) if remat
                    else _adaptive_gather(*args))
    return torch.cat(outs)


# -- separable geometry and the "roi" backward's tiles ---------------------------

TILE = 8  # side in cells of the tiles the "roi" backward's blocks own


def _level_rois(boxes, lvl, pcfg):
    """Each ROI's box on its level, [R, 4] float32, and its width and height
    floored at 1 (roi_geom and meets_tile in csrc/roi_align.cu)."""
    scale = _const(pcfg.scales, boxes.device, torch.float32)[lvl.long()]
    rois = boxes.float() * scale[:, None]
    rw = torch.clamp(rois[:, 2] - rois[:, 0], min=1.0)
    rh = torch.clamp(rois[:, 3] - rois[:, 1], min=1.0)
    return rois, rw, rh


def _sample_coords(boxes, lvl, pcfg):
    """Sample rows ys and columns xs of every ROI on its level, [R, P*S]
    each (sample j % S of bin j // S), rounded as the kernels round them."""
    p, s = pcfg.output_size, pcfg.sampling_ratio
    rois, rw, rh = _level_rois(boxes, lvl, pcfg)
    bin_w = _true_div(rw, p)
    bin_h = _true_div(rh, p)
    j = torch.arange(p * s, device=boxes.device)
    ib = (j // s).float()
    sb = (j % s).float()
    ys = rois[:, 1:2] + ib[None] * bin_h[:, None] + (sb[None] + 0.5) * _true_div(bin_h[:, None], s)
    xs = rois[:, 0:1] + ib[None] * bin_w[:, None] + (sb[None] + 0.5) * _true_div(bin_w[:, None], s)
    return ys, xs


def _axis(v, size):
    """Bilinear cells of sample coordinates v [R, N] on an axis of `size`
    [R, 1] cells, by the gather path's rules: lo, hi [R, N] long (equal at
    the snapped last cell), their weights wlo, whi, and valid (v in
    [-1, size]; an invalid sample contributes 0)."""
    valid = (v >= -1.0) & (v <= size.float())
    v = v.clamp(min=0.0)
    lo = torch.minimum(v.long(), size - 1)
    hi = torch.minimum(lo + 1, size - 1)
    v = torch.where(lo >= size - 1, lo.float(), v)
    whi = v - lo
    return {"lo": lo, "hi": hi, "wlo": 1.0 - whi, "whi": whi, "valid": valid}


def sample_axes(level_shapes, boxes, lvl, pcfg):
    """The separable sample axes of every ROI on its level (the kernels'
    sample_axis): (rows, cols), each a dict of lo, hi, wlo, whi, valid
    [R, P*S] as ``_axis`` gives them. Sample (i, j) of an ROI has the
    corners (rows lo/hi i) x (cols lo/hi j), weights the products of the
    axes' weights, and lies outside unless both axes are valid. On the
    adaptive grid S is ``adaptive_cap`` and each axis also has w [R, P*S],
    the sample's weight on it (1/n, 0 past n: ``adaptive_axis_samples``).
    level_shapes: [(B, Hl, Wl, ...)] per level; lvl [R]."""
    lvl = lvl.long()
    hs = _const([sh[1] for sh in level_shapes], boxes.device)[lvl][:, None]
    ws = _const([sh[2] for sh in level_shapes], boxes.device)[lvl][:, None]
    if pcfg.adaptive:
        ys, wy, xs, wx = _adaptive_axes(boxes, lvl, pcfg, adaptive_cap(pcfg, level_shapes))
        rows, cols = _axis(ys, hs), _axis(xs, ws)
        rows["w"], cols["w"] = wy, wx
        return rows, cols
    ys, xs = _sample_coords(boxes, lvl, pcfg)
    return _axis(ys, hs), _axis(xs, ws)


def roi_footprints(boxes, lvl, pcfg):
    """The cells each ROI's samples may touch on its level, as the "roi"
    backward's blocks test them (meets_tile): [R, 4] float32 of first row,
    last row, first column, last column = floor(y1), floor(y1 + roi_h) + 1,
    floor(x1), floor(x1 + roi_w) + 1. A sample lies in (y1, y1 + roi_h), at
    least half a sample step (roi_h / (2 P S) >= 1 / (2 P S) cells) from
    either end, far beyond its rounding, and touches floor(y) and the next
    cell, clamped into the map; so this holds every cell it touches."""
    rois, rw, rh = _level_rois(boxes, lvl, pcfg)
    y1, x1 = rois[:, 1], rois[:, 0]
    return torch.stack([torch.floor(y1), torch.floor(y1 + rh) + 1,
                        torch.floor(x1), torch.floor(x1 + rw) + 1], dim=1)


def tile_lists(level_shapes, boxes, batch_idx, lvl, pcfg):
    """The "roi" backward's ROI lists, in plain PyTorch: {(level, image,
    tile row, tile column): [ROI, ...]} for every TILE x TILE tile of a
    level's gradient (ragged at the far edges) whose full TILE x TILE extent
    meets an ROI's footprint, the ROIs of that level and image in index
    order (the kernel's order: a stable sort by level, then image)."""
    foot = roi_footprints(boxes, lvl, pcfg).tolist()
    lists = {}
    for r, (l, b) in enumerate(zip(lvl.tolist(), batch_idx.tolist())):
        h, w = level_shapes[l][1], level_shapes[l][2]
        ylo, yhi, xlo, xhi = foot[r]
        for ty in range(-(-h // TILE)):
            if not (yhi >= ty * TILE and ylo <= ty * TILE + TILE - 1):
                continue
            for tx in range(-(-w // TILE)):
                if xhi >= tx * TILE and xlo <= tx * TILE + TILE - 1:
                    lists.setdefault((l, b, ty, tx), []).append(r)
    return lists


def _tile_weights(axis, r, cells, p, s):
    """[P, len(cells)]: per bin, the summed bilinear weights that ROI r's
    valid samples give each of `cells` on one axis (on the adaptive grid,
    each times the sample's weight, as the kernel folds it in)."""
    lo, hi = axis["lo"][r][:, None], axis["hi"][r][:, None]
    wlo, whi = axis["wlo"][r], axis["whi"][r]
    if "w" in axis:
        wlo, whi = axis["w"][r] * wlo, axis["w"][r] * whi
    w = (wlo[:, None] * (lo == cells) + whi[:, None] * (hi == cells))
    w = w * axis["valid"][r][:, None]
    return w.reshape(p, s, -1).sum(dim=1)


def tile_owner_gradient(level_shapes, boxes, batch_idx, pcfg, dout):
    """d features of the pooler in the "roi" backward's decomposition, in
    plain float32 PyTorch: each tile of each level's gradient is the sum,
    over the ROIs ``tile_lists`` gives it, of RowW^T . dOut . ColW over the
    tile's rows and columns, / S^2 (on the adaptive grid RowW and ColW carry
    the samples' weights 1/n instead); tiles no ROI meets stay zero. dout
    [R, P, P, C] -> one [B, Hl, Wl, C] gradient per level."""
    p = pcfg.output_size
    s, _ = kernel_samples(pcfg, level_shapes)
    dev = boxes.device
    lvl = assign_levels(boxes, pcfg) if len(level_shapes) > 1 else \
        torch.zeros((boxes.shape[0],), dtype=torch.int32, device=dev)
    rows, cols = sample_axes(level_shapes, boxes, lvl, pcfg)
    grads = [torch.zeros(tuple(sh), dtype=torch.float32, device=dev) for sh in level_shapes]
    for (l, b, ty, tx), rois in tile_lists(level_shapes, boxes, batch_idx, lvl, pcfg).items():
        h, w = level_shapes[l][1], level_shapes[l][2]
        y0, x0 = ty * TILE, tx * TILE
        ycells = torch.arange(y0, min(y0 + TILE, h), device=dev)
        xcells = torch.arange(x0, min(x0 + TILE, w), device=dev)
        tile = grads[l][b, y0:y0 + TILE, x0:x0 + TILE]
        for r in rois:
            roww = _tile_weights(rows, r, ycells, p, s)
            colw = _tile_weights(cols, r, xcells, p, s)
            tile += torch.einsum("py,pqc,qx->yxc", roww, dout[r].float(), colw)
    return grads if pcfg.adaptive else [g / (s * s) for g in grads]


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


def _oversize(coords, mask):
    """[R]: a valid sample of `coords` [R, P*S] (relative to the window
    origin) reaches a cell beyond the window."""
    low = torch.floor(coords)
    return (mask & (low.long() + (coords > low).long() >= PATCH)).any(dim=1)


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
    return w, _oversize(coords, mask)


def _level_rows(shapes):
    """Per level: H, W, the largest window origin on each axis (TPU levels
    are padded to >= 48 and a multiple of 8), and the tiles of the tile
    kernels: the level's first tile number, tile rows and tile columns
    (tiles numbered image-major, then row-major, level after level). Also
    returns the number of tiles."""
    rows, first = [], 0
    for nb, h, w, *_ in shapes:
        ty, tx = -(-h // TILE), -(-w // TILE)
        rows.append([h, w, max(PATCH, ty * TILE) - PATCH, max(PATCH, tx * TILE) - PATCH,
                     first, ty, tx])
        first += nb * ty * tx
    return rows, first


def _window_geometry(shapes, boxes, bidx, lvl, pcfg):
    """Each ROI's window, as _precompute (roi_align_kernel.py:126) places
    it: an origin y0, x0 [R] long at the first sample's cell rounded down
    to 8 and clipped so the window ends within the TPU kernel's padded
    level; the sample coordinates clamped into the level, relative to the
    origin, ys, xs [R, P*S], with masks ymask, xmask (false where a sample
    contributes 0); and tile [R], the number of the 8 x 8 tile at the
    origin in the tile kernels' numbering, which orders the ROIs as the
    window key (level, image, y0 / 8, x0 / 8) does."""
    lvl = lvl.long()
    lv = _const(_level_rows(shapes)[0], boxes.device)[lvl]
    hs, ws = lv[:, 0:1].float(), lv[:, 1:2].float()
    ys, xs = _sample_coords(boxes, lvl, pcfg)
    ymask = (ys >= -1.0) & (ys <= hs)
    xmask = (xs >= -1.0) & (xs <= ws)
    ys = torch.minimum(torch.clamp(ys, min=0.0), hs - 1.0)
    xs = torch.minimum(torch.clamp(xs, min=0.0), ws - 1.0)
    y0 = torch.minimum(torch.floor(ys.amin(dim=1)).long() // 8 * 8, lv[:, 2])
    x0 = torch.minimum(torch.floor(xs.amin(dim=1)).long() // 8 * 8, lv[:, 3])
    tile = lv[:, 4] + (bidx.long() * lv[:, 5] + y0 // TILE) * lv[:, 6] + x0 // TILE
    return dict(ys=ys - y0[:, None].float(), ymask=ymask, xs=xs - x0[:, None].float(),
                xmask=xmask, y0=y0, x0=x0, tile=tile)


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
      oversize [R]           ROIs whose samples reach beyond their window
      rp                     R padded to a multiple of CHUNK; padding rows
                             repeat the last row's window
    On ROIs that fit their window every entry equals _precompute's. The
    kernels read the window index (window_kernel_inputs), not this layout."""
    p, s = pcfg.output_size, pcfg.sampling_ratio
    r = boxes.shape[0]
    lvl = lvl.long()
    geo = _window_geometry(shapes, boxes, batch_idx, lvl, pcfg)
    y0, x0 = geo["y0"], geo["x0"]
    roww, over_y = _window_weights(geo["ys"], geo["ymask"], p, s)
    colw, over_x = _window_weights(geo["xs"], geo["xmask"], p, s)
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
    lasts, so that most q-row chunks hold one window only. Takes rwid, rnew
    [rp] and rp of a layout; returns src [n] (the sorted row of each chunk
    row; padding rows repeat their window's last one), real [n] (false for
    padding), rnew [n] (1 where a window starts), pure [n / q] (1 for a
    chunk of one window), pos [rp] (the chunk row of each sorted row) and
    n."""
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
    return dict(src=src, real=hit >= 0, rnew=rnew_c, pure=pure, pos=pos, n=n)


# -- window index of the "rmw" and "chunk" backwards --------------------------

SPAN = PATCH // TILE  # window origins per axis (in tiles) whose cells reach a tile
PURE_ROW = 1 << 30    # flags the "chunk" index's rows of pure chunks (roi_align.cu kPureRow)


def row_roi(v):
    """(ROI, pure) of an entry of the window index's ``roi``: ROI -1 for
    padding rows and oversize ROIs; pure for the "chunk" index's rows of
    pure chunks."""
    return (v & ~PURE_ROW, bool(v & PURE_ROW)) if v >= 0 else (-1, False)
_NONE = torch.iinfo(torch.int32).max  # `first` of a tile that is no window's origin


def window_kernel_inputs(kind, shapes, boxes, batch_idx, lvl, pcfg):
    """The window index the "rmw" or "chunk" kernel walks, on the ROIs'
    device and without a read-back to the host. The rows are the sorted
    rows of ``window_layout`` ("rmw"), or the rows of its ``chunk_layout``
    ("chunk"); a tile's candidates are the rows of the SPAN x SPAN windows
    whose origin lies in [ty - SPAN + 1, ty] x [tx - SPAN + 1, tx] tiles
    (the only windows whose 48 x 48 cells reach it), then its (level,
    image)'s oversize ROIs. Returns a dict:
      roi [rows] int32         the ROI of each row, -1 for padding rows and
                               oversize ROIs; ("chunk") PURE_ROW added on
                               the rows of pure chunks (``row_roi``)
      first, end [tiles] int32 the rows [first, end) of the window whose
                               origin is each 8 x 8 tile, tiles numbered as
                               the tile kernels' blocks (end <= first: none)
      over_order, over_seg     ``roi_tile_inputs`` of the oversize ROIs alone
      oversize [R] bool, and ("chunk") the chunk layout under "chunks"."""
    dev, r = boxes.device, boxes.shape[0]
    geo = _window_geometry(shapes, boxes, batch_idx, lvl, pcfg)
    oversize = _oversize(geo["ys"], geo["ymask"]) | _oversize(geo["xs"], geo["xmask"])
    perm = torch.argsort(geo["tile"], stable=True)
    stile = geo["tile"][perm]
    roi = torch.where(oversize[perm], -1, perm)
    out = {"oversize": oversize}
    if kind == "chunk":
        rnew = torch.ones_like(stile)
        rnew[1:] = (stile[1:] != stile[:-1]).long()
        pad = (-r) % CHUNK
        rnew = torch.cat([rnew, rnew.new_zeros(pad)])
        ch = chunk_layout({"rwid": torch.cumsum(rnew, 0) - 1, "rnew": rnew, "rp": r + pad})
        at = ch["pos"][:r]
        roi = torch.where(ch["real"], torch.cat([roi, roi.new_full((pad,), -1)])[ch["src"]], -1)
        pure = ch["pure"].repeat_interleave(CHUNK).bool() & (roi >= 0)
        roi = torch.where(pure, roi | PURE_ROW, roi)
        out["chunks"] = ch
    else:
        at = torch.arange(r, device=dev)
    ntiles = _level_rows(shapes)[1]
    out["first"] = torch.full((ntiles,), _NONE, dtype=torch.long, device=dev).scatter_reduce_(
        0, stile, at, "amin").int()
    out["end"] = torch.zeros(ntiles, dtype=torch.long, device=dev).scatter_reduce_(
        0, stile, at + 1, "amax").int()
    out["roi"] = roi.int()
    over = roi_tile_inputs(shapes, batch_idx, torch.where(oversize, lvl.long(), len(shapes)))
    out["over_order"], out["over_seg"] = over["order"], over["seg"]
    return out


def window_tile_gradient(kind, level_shapes, boxes, batch_idx, pcfg, dout):
    """d features of the pooler in the "rmw" / "chunk" backwards'
    decomposition, in plain float32 PyTorch: the tile owners of
    ``tile_owner_gradient`` with each tile's ROIs taken from the window
    index (``window_kernel_inputs``): the rows of its SPAN x SPAN windows in
    key, then row order, then its (level, image)'s oversize ROIs, those
    whose footprint meets the tile adding RowW^T . dOut . ColW ("chunk":
    the rows of pure chunks first, as its kernel sums them apart). dout
    [R, P, P, C] -> one [B, Hl, Wl, C] gradient per level."""
    p, s = pcfg.output_size, pcfg.sampling_ratio
    dev = boxes.device
    lvl = assign_levels(boxes, pcfg) if len(level_shapes) > 1 else \
        torch.zeros((boxes.shape[0],), dtype=torch.int32, device=dev)
    idx = window_kernel_inputs(kind, level_shapes, boxes, batch_idx, lvl, pcfg)
    first, end, roi = idx["first"].tolist(), idx["end"].tolist(), idx["roi"].tolist()
    order, seg = idx["over_order"].tolist(), idx["over_seg"].tolist()
    foot = roi_footprints(boxes, lvl, pcfg).tolist()
    rows, cols = sample_axes(level_shapes, boxes, lvl, pcfg)
    grads = [torch.zeros(tuple(sh), dtype=torch.float32, device=dev) for sh in level_shapes]
    nb, base = level_shapes[0][0], 0
    for l, (_, h, w, _) in enumerate(level_shapes):
        ty_n, tx_n = -(-h // TILE), -(-w // TILE)
        for b, ty, tx in itertools.product(range(nb), range(ty_n), range(tx_n)):
            keys = [base + (b * ty_n + wy) * tx_n + wx
                    for wy in range(max(ty - SPAN + 1, 0), ty + 1)
                    for wx in range(max(tx - SPAN + 1, 0), tx + 1)]
            walk = [row_roi(roi[j]) for key in keys for j in range(first[key], end[key])]
            cands = [r for r, pure in walk if pure] + [r for r, pure in walk if not pure]
            cands += order[seg[l * nb + b]:seg[l * nb + b + 1]]
            y0, x0 = ty * TILE, tx * TILE
            hits = [r for r in cands if r >= 0 and foot[r][1] >= y0 and foot[r][0] <= y0 + TILE - 1
                    and foot[r][3] >= x0 and foot[r][2] <= x0 + TILE - 1]
            if not hits:
                continue
            ycells = torch.arange(y0, min(y0 + TILE, h), device=dev)
            xcells = torch.arange(x0, min(x0 + TILE, w), device=dev)
            tile = grads[l][b, y0:y0 + TILE, x0:x0 + TILE]
            for r in hits:
                tile += torch.einsum("py,pqc,qx->yxc", _tile_weights(rows, r, ycells, p, s),
                                     dout[r].float(), _tile_weights(cols, r, xcells, p, s))
        base += nb * ty_n * tx_n
    return [g / (s * s) for g in grads]


# -- CUDA kernels ---------------------------------------------------------------

_I, _P = ctypes.c_int, ctypes.c_void_p


def _lib():
    lib = native.load("roi_align")
    if not getattr(lib, "_typed", False):
        lib.roi_align_forward.argtypes = [_P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                                          _P, _P, _I]
        lib.roi_align_backward.argtypes = [_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I,
                                           _I, _P, _P, _I]
        lib.roi_align_backward_windows.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I,
                                                   _I, _I, _P, _P, _P, _P, _P, _P, _P]
        for fn in (lib.roi_align_forward, lib.roi_align_backward,
                   lib.roi_align_backward_windows, lib.roi_align_max_levels,
                   lib.roi_align_window_max_p):
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_vector_access(what, c, tensors):
    """The kernels move 8 channels a thread in 16-byte loads and stores."""
    if c % 8 != 0:
        raise ValueError("{} kernel takes C % 8 == 0 channels, not {}".format(what, c))
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("{} kernel takes 16-byte aligned buffers".format(what))


def _level_arrays(shapes, pcfg):
    """Heights, widths and scales of the levels as ctypes arrays."""
    n = len(shapes)
    return ((ctypes.c_int * n)(*[shape[1] for shape in shapes]),
            (ctypes.c_int * n)(*[shape[2] for shape in shapes]),
            (ctypes.c_float * n)(*pcfg.scales))


def _level_offsets(shapes):
    """(start of each level in the flat gradient, total elements)."""
    offsets, off = [], 0
    for shape in shapes:
        offsets.append(off)
        off += math.prod(shape)
    return (ctypes.c_longlong * len(shapes))(*offsets), off


def kernel_samples(pcfg, level_shapes):
    """(s, adaptive) the kernels take: the fixed grid's samples a bin an
    axis and 0, or the adaptive grid's cap (``adaptive_cap``) and 1."""
    if pcfg.adaptive:
        return adaptive_cap(pcfg, level_shapes), 1
    return pcfg.sampling_ratio, 0


def launch(features, boxes, bidx, lvl, pcfg, out):
    """The kernel alone, on prepared buffers: NHWC-contiguous levels, boxes
    [R, 4] f32, batch_idx and level [R] int32 in, out [R, P, P, C] in the
    features' dtype. Launches on the current stream."""
    num_levels = len(features)
    ptrs = (ctypes.c_void_p * num_levels)(*[f.data_ptr() for f in features])
    shapes = [f.shape for f in features]
    hs, ws, scales = _level_arrays(shapes, pcfg)
    r, p, c = out.shape[0], out.shape[1], out.shape[3]
    s, adaptive = kernel_samples(pcfg, shapes)
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    rc = _lib().roi_align_forward(
        ptrs, hs, ws, scales, num_levels, boxes.data_ptr(), bidx.data_ptr(),
        lvl.data_ptr(), r, c, p, s, _DTYPE_CODES[out.dtype], out.data_ptr(), stream, adaptive,
    )
    native.check(rc, "roi_align")


def roi_tile_inputs(shapes, bidx, lvl):
    """The "roi" backward's ROI lists on the device, without a read-back:
    order [R] int32, the ROIs sorted by (level, image), stable; seg
    [levels * B + 1] int32, the first position in order of each (level,
    image) segment, then R."""
    nb = shapes[0][0]
    key = lvl.long() * nb + bidx.long()
    order = torch.argsort(key, stable=True)
    bounds = torch.arange(len(shapes) * nb + 1, device=key.device)
    seg = torch.searchsorted(key[order], bounds)
    return {"order": order.to(torch.int32), "seg": seg.to(torch.int32)}


def launch_backward(shapes, boxes, pcfg, dout, out, kind="roi", inputs=None):
    """A backward kernel alone, on prepared buffers: level shapes [(B, Hl,
    Wl, C)], boxes [R, 4] f32, dout [R, P, P, C] contiguous, out a buffer of
    sum(B*Hl*Wl*C) elements in dout's dtype, written whole; `inputs` from
    roi_tile_inputs ("roi") or window_kernel_inputs ("rmw", "chunk").
    Launches on the current stream."""
    stream = torch.cuda.current_stream(boxes.device).cuda_stream
    offsets, _ = _level_offsets(shapes)
    levels = [out.data_ptr(), offsets, *_level_arrays(shapes, pcfg), len(shapes), shapes[0][0],
              boxes.data_ptr()]
    s, adaptive = kernel_samples(pcfg, shapes)
    grad = [dout.shape[3], dout.shape[1], s, _DTYPE_CODES[dout.dtype], dout.data_ptr()]
    lib = _lib()
    if kind == "roi":
        rc = lib.roi_align_backward(*levels, inputs["order"].data_ptr(),
                                    inputs["seg"].data_ptr(), *grad, stream, adaptive)
    else:
        rc = lib.roi_align_backward_windows(
            int(kind == "chunk"), *levels, *grad, inputs["first"].data_ptr(),
            inputs["end"].data_ptr(), inputs["roi"].data_ptr(),
            inputs["over_order"].data_ptr(), inputs["over_seg"].data_ptr(), stream)
    native.check(rc, "roi_align_backward ({})".format(kind))


def _backward(kind, dout, shapes, boxes, bidx, lvl, pcfg):
    if dout.dtype not in _DTYPE_CODES:
        raise TypeError("roi_align backward takes float32 or bfloat16 gradients")
    if kind != "roi" and pcfg.adaptive:
        raise ValueError("the window backwards take a fixed sampling ratio")
    if kind != "roi" and pcfg.output_size > _lib().roi_align_window_max_p():
        raise ValueError("the window backwards take P <= {}".format(
            _lib().roi_align_window_max_p()))
    dout = dout.contiguous()
    _check_vector_access("roi_align backward", dout.shape[3], [dout])
    sizes = [math.prod(shape) for shape in shapes]
    out = torch.empty((sum(sizes),), dtype=dout.dtype, device=dout.device)
    if kind == "roi":
        inputs = roi_tile_inputs(shapes, bidx, lvl)
    else:
        inputs = window_kernel_inputs(kind, shapes, boxes, bidx, lvl, pcfg)
    launch_backward(shapes, boxes, pcfg, dout, out, kind, inputs)
    return [g.view(shape) for g, shape in zip(out.split(sizes), shapes)]


def roi_align_backward(dout, shapes, boxes, bidx, lvl, pcfg):
    """d features of the kernel's forward by the "roi" backward: dout
    [R, P, P, C] (float32 or bfloat16, CUDA, C % 8 == 0) -> one
    NHWC-contiguous [B, Hl, Wl, C] gradient per level in dout's dtype,
    summed in float32 in a fixed order and rounded once: two calls give the
    same bits."""
    grads = _backward("roi", dout, shapes, boxes, bidx, lvl, pcfg)
    roi_align_backward.launches += 1
    return grads


def roi_align_backward_rmw(dout, shapes, boxes, bidx, lvl, pcfg):
    """The same gradient by the "rmw" backward: the tile blocks take their
    ROIs from the window index's sorted rows. Two calls give the same
    bits."""
    grads = _backward("rmw", dout, shapes, boxes, bidx, lvl, pcfg)
    roi_align_backward_rmw.launches += 1
    return grads


def roi_align_backward_chunk(dout, shapes, boxes, bidx, lvl, pcfg):
    """The same gradient by the "chunk" backward: the tile blocks take their
    ROIs from the window index's chunk rows. Two calls give the same
    bits."""
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
    named at the forward (``backward_choice``; "roi" for the adaptive grid),
    as JAX fixes its choice when it traces. Saves boxes, image indices,
    levels and the level shapes, not the features. The boxes and image
    indices get no gradient (the JAX vjp's float0)."""

    @staticmethod
    def forward(ctx, pcfg, bwd, boxes, bidx, lvl, *features):
        r, p, c = boxes.shape[0], pcfg.output_size, features[0].shape[3]
        out = torch.empty((r, p, p, c), dtype=features[0].dtype, device=boxes.device)
        if r > 0:
            launch(features, boxes, bidx, lvl, pcfg, out)
            multilevel_roi_align.launches += 1
            multilevel_roi_align.adaptive_launches += int(pcfg.adaptive)
        ctx.pcfg = pcfg
        ctx.bwd = bwd
        ctx.shapes = [tuple(f.shape) for f in features]
        ctx.save_for_backward(boxes, bidx, lvl)
        return out

    @staticmethod
    def backward(ctx, dout):
        boxes, bidx, lvl = ctx.saved_tensors
        with span("roi_pool.bwd"):
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
    _check_vector_access("roi_align", c, features)
    boxes = boxes.detach().contiguous()
    bidx = batch_idx.to(torch.int32).contiguous()
    if len(features) > 1:
        lvl = assign_levels(boxes, pcfg).contiguous()
    else:
        lvl = torch.zeros_like(bidx)
    return RoIAlignFunction.apply(pcfg, bwd, boxes, bidx, lvl, *features)


def multilevel_roi_align(features, boxes, batch_idx, pcfg, rois_per_image=None):
    """Pool each ROI from its assigned level. features: list of NHWC
    [B, Hl, Wl, C], one per scale; boxes [R, 4]; batch_idx [R] ->
    [R, P, P, C] in the features' dtype. The fixed grid's backward kernel is
    read from the environment here (``backward_choice``) on every device;
    the adaptive grid's is "roi". CPU tensors take the plain versions and
    their autograd whatever it names: ``multilevel_roi_align_plain``, or
    ``adaptive_roi_align`` with rois_per_image as it describes (the kernels
    do not need it)."""
    if len(features) != len(pcfg.scales):
        raise ValueError("one feature map per pooler scale")
    with span("roi_pool"):
        bwd = "roi" if pcfg.adaptive else backward_choice(pcfg)
        if boxes.device.type == "cpu" and pcfg.adaptive:
            return adaptive_roi_align(features, boxes, batch_idx, pcfg, rois_per_image)
        if boxes.device.type == "cpu":
            return multilevel_roi_align_plain(features, boxes, batch_idx, pcfg)
        if boxes.device.type != "cuda":
            raise ValueError("roi_align runs on cpu or cuda tensors, not {}".format(
                boxes.device))
        return _roi_align_cuda(features, boxes, batch_idx, pcfg, bwd)


multilevel_roi_align.launches = 0
multilevel_roi_align.adaptive_launches = 0  # the forwards of the adaptive grid
