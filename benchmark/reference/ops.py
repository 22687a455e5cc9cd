"""Plain PyTorch operations of the reference Mask R-CNN.

A frozen copy of the plain versions in maskrcnn_tpu_torch (ops/box_ops.py,
ops/losses.py, ops/sampler.py, ops/matcher.py:match_proposals and
match_anchors_plain, ops/nms.py:batched_nms_plain, models/poolers.py: the
gather path multilevel_roi_align_plain and the adaptive pooler with its
matmul path), with the hand-kernel dispatch, the process-group reductions
and the callers' timing ranges taken out. It imports nothing of the
program: the benchmark holds the program to it, so it must not change when
the program does.
"""

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

TO_REMOVE = 1.0
BBOX_XFORM_CLIP = math.log(1000.0 / 16)
NEG_INF = -1e10
BELOW_LOW_QUALITY = -1
BETWEEN_THRESHOLDS = -2

# -- boxes ---------------------------------------------------------------------


def box_area(boxes):
    return (boxes[..., 2] - boxes[..., 0] + TO_REMOVE) * (boxes[..., 3] - boxes[..., 1] + TO_REMOVE)


def box_iou(boxes1, boxes2):
    """Pairwise IoU, [..., N, 4] x [..., M, 4] -> [..., N, M]."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt + TO_REMOVE).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def encode_boxes(reference_boxes, proposals, weights=(1.0, 1.0, 1.0, 1.0)):
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
    return torch.stack([wx * (gt_cx - ex_cx) / ex_w, wy * (gt_cy - ex_cy) / ex_h,
                        ww * torch.log(gt_w / ex_w), wh * torch.log(gt_h / ex_h)], dim=-1)


def decode_boxes(rel_codes, boxes, weights=(1.0, 1.0, 1.0, 1.0)):
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
    out = torch.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                       pred_ctr_x + 0.5 * pred_w - 1, pred_ctr_y + 0.5 * pred_h - 1], dim=-1)
    return out.reshape(rel_codes.shape)


def clip_boxes_to_image(boxes, image_size):
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


# -- losses ----------------------------------------------------------------------


def smooth_l1_loss(input, target, beta=1.0 / 9):
    n = (input - target).abs()
    return torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)


def softmax_cross_entropy(logits, labels, mask):
    log_probs = F.log_softmax(logits, dim=-1)
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    nll = -log_probs.gather(-1, safe[..., None])[..., 0]
    mask = mask.to(logits.dtype)
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def binary_cross_entropy_with_logits(logits, targets):
    return F.softplus(logits) - logits * targets


# -- top-k and sampling -------------------------------------------------------------


def top_k_stable(x, k):
    """Descending, ties broken by the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k_fast(x, k):
    """The program's rpn.top_k_fast: torch.topk on long rows, else stable."""
    if x.shape[-1] >= 8192 and k >= 64:
        return torch.topk(x, k, dim=-1)
    return top_k_stable(x, k)


def sample_topk_indices(labels, pos_draw, neg_draw, batch_size_per_image, positive_fraction):
    """Fixed-shape balanced sampler: (indices, valid, is_pos) [..., K]."""
    n = labels.shape[-1]
    k_out = min(batch_size_per_image, n)
    num_pos_quota = min(int(batch_size_per_image * positive_fraction), k_out)
    neg_inf = torch.full_like(pos_draw, NEG_INF)
    pos_priority = torch.where(labels >= 1, pos_draw, neg_inf)
    neg_priority = torch.where(labels == 0, neg_draw, neg_inf)
    neg_vals, neg_idx = top_k_stable(neg_priority, k_out)
    real_neg = neg_vals > NEG_INF / 2
    pos_vals, pos_idx = top_k_stable(pos_priority, num_pos_quota)
    real_pos = pos_vals > NEG_INF / 2
    num_pos = real_pos.sum(dim=-1, keepdim=True)
    pos_vals = torch.where(real_pos, pos_vals + 2.0, torch.full_like(pos_vals, NEG_INF))
    rank = torch.arange(k_out, device=labels.device)
    neg_ok = (rank < batch_size_per_image - num_pos) & real_neg
    neg_vals = torch.where(neg_ok, neg_vals + 1.0, torch.full_like(neg_vals, NEG_INF))
    cand_vals = torch.cat([pos_vals, neg_vals], dim=-1)
    cand_idx = torch.cat([pos_idx, neg_idx], dim=-1)
    top_p, sel = top_k_stable(cand_vals, k_out)
    idx = torch.gather(cand_idx, -1, sel)
    return idx, top_p > 0, top_p >= 2.0


# -- matching -------------------------------------------------------------------------


def _thresholds(vals, matches, high, low):
    out = torch.where(vals < low, torch.full_like(matches, BELOW_LOW_QUALITY), matches)
    between = (vals >= low) & (vals < high)
    return torch.where(between, torch.full_like(matches, BETWEEN_THRESHOLDS), out)


def match_proposals(iou, gt_valid, high_threshold, low_threshold, allow_low_quality_matches=False):
    """iou [..., G, N], gt_valid [..., G] -> [..., N] int32: >= 0 gt index,
    -1 below low, -2 between."""
    iou = torch.where(gt_valid[..., :, None], iou, torch.full_like(iou, -1.0))
    vals, matches = iou.max(dim=-2)
    matches = matches.to(torch.int32)
    out = _thresholds(vals, matches, high_threshold, low_threshold)
    if allow_low_quality_matches:
        best = iou.max(dim=-1, keepdim=True).values
        is_best = (iou == best) & gt_valid[..., :, None] & (best > 0)
        out = torch.where(is_best.any(dim=-2), matches, out)
    return out


def match_anchors(anchors, gt_boxes, gt_valid, high_threshold, low_threshold):
    """anchors [N, 4], gt [B, G, 4] -> [B, N] int32, one image at a time."""
    return torch.stack([
        match_proposals(box_iou(gt_boxes[i], anchors), gt_valid[i], high_threshold,
                        low_threshold, allow_low_quality_matches=True)
        for i in range(gt_boxes.shape[0])])


# -- NMS ------------------------------------------------------------------------------------


def batched_nms(boxes, scores, valid, iou_threshold, rows=1024):
    """Greedy keep-mask NMS over lanes: boxes [G, N, 4], scores and valid
    [G, N] -> keep [G, N] in the original order."""
    g, n, _ = boxes.shape
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.sort(masked, dim=1, descending=True, stable=True).indices
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    keep = torch.gather(valid, 1, order)
    sup = torch.empty((g, n, n), dtype=torch.bool, device=boxes.device)
    cols = torch.arange(n, device=boxes.device)
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        later = cols[None, :] > cols[r0:r1, None]
        sup[:, r0:r1] = (box_iou(sboxes[:, r0:r1], sboxes) > iou_threshold) & later
    for i in range(n):
        keep = keep & ~(keep[:, i:i + 1] & sup[:, i])
    return torch.zeros_like(keep).scatter_(1, order, keep)


# -- ROIAlign -----------------------------------------------------------------------------


class PoolerConfig:
    canonical_scale = 224
    canonical_level = 4
    adaptive_max = 8

    def __init__(self, output_size, scales, sampling_ratio):
        self.output_size = int(output_size)
        self.scales = tuple(scales)
        self.adaptive = int(sampling_ratio) <= 0
        self.sampling_ratio = int(sampling_ratio)
        self.k_min = -int(math.log2(self.scales[0]))
        self.k_max = -int(math.log2(self.scales[-1]))


def _true_div(x, d):
    return x / torch.full((), float(d), dtype=x.dtype, device=x.device)


def assign_levels(boxes, pcfg):
    area = torch.clamp(boxes[..., 2] - boxes[..., 0] + TO_REMOVE, min=0) * torch.clamp(
        boxes[..., 3] - boxes[..., 1] + TO_REMOVE, min=0)
    target = torch.floor(pcfg.canonical_level
                         + torch.log2(_true_div(torch.sqrt(area), pcfg.canonical_scale) + 1e-6))
    return (torch.clamp(target, pcfg.k_min, pcfg.k_max) - pcfg.k_min).to(torch.int32)


def _level_rois(boxes, lvl, pcfg):
    scale = torch.tensor(pcfg.scales, dtype=torch.float32, device=boxes.device)[lvl.long()]
    rois = boxes.float() * scale[:, None]
    rw = torch.clamp(rois[:, 2] - rois[:, 0], min=1.0)
    rh = torch.clamp(rois[:, 3] - rois[:, 1], min=1.0)
    return rois, rw, rh


def _corners(level_shapes, batch_idx, lvl, ys, xs):
    dev = ys.device
    r, ny, nx = ys.shape[0], ys.shape[1], xs.shape[1]
    offsets, off = [], 0
    for shape in level_shapes:
        offsets.append(off)
        off += shape[0] * shape[1] * shape[2]
    lvl = lvl.long()
    roi_h = torch.tensor([s[1] for s in level_shapes], device=dev)[lvl]
    roi_w = torch.tensor([s[2] for s in level_shapes], device=dev)[lvl]
    roi_off = torch.tensor(offsets, device=dev)[lvl] + batch_idx.long() * (roi_h * roi_w)
    y = ys[:, :, None].expand(r, ny, nx)
    x = xs[:, None, :].expand(r, ny, nx)
    outside = ((y < -1.0) | (y > roi_h.float()[:, None, None]) | (x < -1.0)
               | (x > roi_w.float()[:, None, None]))
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
    index = torch.stack([base + y_low * w_i + x_low, base + y_low * w_i + x_high,
                         base + y_high * w_i + x_low, base + y_high * w_i + x_high])
    weight = torch.stack([hy * hx, hy * lx, ly * hx, ly * lx])
    return index, weight, outside


def _gather_bins(flat, index, weight, outside):
    w = weight[..., None].to(flat.dtype)
    val = (w[0] * flat[index[0]] + w[1] * flat[index[1]]
           + w[2] * flat[index[2]] + w[3] * flat[index[3]])
    return torch.where(outside[..., None], torch.zeros((), dtype=flat.dtype, device=flat.device), val)


def roi_align_fixed(features, boxes, batch_idx, pcfg):
    """ROIAlign at a fixed sampling ratio S (the FPN heads): NHWC levels,
    boxes [R, 4], batch_idx [R] -> [R, P, P, C], the S x S bilinear samples
    of each bin averaged."""
    p, s = pcfg.output_size, pcfg.sampling_ratio
    c = features[0].shape[-1]
    r = boxes.shape[0]
    flat = torch.cat([f.reshape(-1, c) for f in features], dim=0)
    shapes = [f.shape[:3] for f in features]
    lvl = assign_levels(boxes, pcfg).long() if len(features) > 1 else \
        torch.zeros((r,), dtype=torch.long, device=boxes.device)
    rois, rw, rh = _level_rois(boxes, lvl, pcfg)
    bin_w = _true_div(rw, p)
    bin_h = _true_div(rh, p)
    j = torch.arange(p * s, device=boxes.device)
    ib = (j // s).float()
    sb = (j % s).float()
    ys = rois[:, 1:2] + ib[None] * bin_h[:, None] + (sb[None] + 0.5) * _true_div(bin_h[:, None], s)
    xs = rois[:, 0:1] + ib[None] * bin_w[:, None] + (sb[None] + 0.5) * _true_div(bin_w[:, None], s)
    val = _gather_bins(flat, *_corners(shapes, batch_idx, lvl, ys, xs))
    return val.reshape(r, p, s, p, s, c).mean(dim=(2, 4))


# ratio 0 (the C4 heads): n = clip(ceil(bin), 1, s) samples a bin an axis
CHUNK_BYTES = 1 << 29


def adaptive_axis_samples(origin, bin_sz, p, s_max):
    n = torch.clamp(torch.ceil(bin_sz), 1.0, float(s_max))
    j = torch.arange(p * s_max, device=origin.device)
    binidx = (j // s_max).float()
    k = (j % s_max).float()
    pos = origin[:, None] + binidx[None] * bin_sz[:, None] + (k[None] + 0.5) * (
        bin_sz[:, None] / n[:, None])
    wt = (k[None] < n[:, None]).float() / n[:, None]
    return pos, wt


def _adaptive_axes(boxes, lvl, pcfg, s):
    p = pcfg.output_size
    rois, rw, rh = _level_rois(boxes, lvl, pcfg)
    ys, wy = adaptive_axis_samples(rois[:, 1], _true_div(rh, p), p, s)
    xs, wx = adaptive_axis_samples(rois[:, 0], _true_div(rw, p), p, s)
    return ys, wy, xs, wx


def _adaptive_gather(flat, level_shapes, boxes, batch_idx, pcfg, s):
    p, c = pcfg.output_size, flat.shape[-1]
    r = boxes.shape[0]
    lvl = torch.zeros((r,), dtype=torch.int32, device=boxes.device)
    ys, wy, xs, wx = _adaptive_axes(boxes, lvl, pcfg, s)
    val = _gather_bins(flat, *_corners(level_shapes, batch_idx, lvl, ys, xs))
    wgt = (wy[:, :, None] * wx[:, None, :]).to(flat.dtype)
    return (val * wgt[..., None]).reshape(r, p, s, p, s, c).sum(dim=(2, 4))


def _dense_axis_weights(coords, w, size, p, s):
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


def matmul_pool(feature, boxes, pcfg, k_per_image, s):
    """The adaptive grid on one level as two products against the map:
    out = ColW . (RowW . F), per image block of k_per_image ROIs."""
    b, h, w, c = feature.shape
    p, dtype = pcfg.output_size, feature.dtype
    r = boxes.shape[0]
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
        return torch.einsum("bkjw,bkiwc->bkijc", wc, a).contiguous()

    remat = torch.is_grad_enabled() and f2.requires_grad
    out = torch.cat([
        checkpoint(body, roww[:, i:i + kc], colw[:, i:i + kc], f2, use_reentrant=False)
        if remat else body(roww[:, i:i + kc], colw[:, i:i + kc], f2)
        for i in range(0, k_per_image, kc)], dim=1)
    return out.reshape(r, p, p, c)


def roi_align_adaptive(features, boxes, batch_idx, pcfg, rois_per_image=None):
    """ROIAlign at sampling ratio 0 on one level (the C4 heads): image-major
    blocks of rois_per_image by matmul_pool, other ROIs by the gather path
    in chunks."""
    p = pcfg.output_size
    h, w = features[0].shape[1], features[0].shape[2]
    s = min(pcfg.adaptive_max, max(-(-h // p), -(-w // p), 1))
    if rois_per_image and boxes.shape[0] == features[0].shape[0] * rois_per_image:
        return matmul_pool(features[0], boxes, pcfg, rois_per_image, s)
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


def roi_align(features, boxes, batch_idx, pcfg, rois_per_image=None):
    if pcfg.adaptive:
        return roi_align_adaptive(features, boxes, batch_idx, pcfg, rois_per_image)
    return roi_align_fixed(features, boxes, batch_idx, pcfg)
