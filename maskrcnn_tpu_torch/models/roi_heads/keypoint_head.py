"""ROI keypoint head: 8-conv extractor, deconv predictor, heatmap targets,
loss and the two decodes.

PyTorch counterpart of maskrcnn_tpu/models/roi_heads/keypoint_head.py
(after the reference's keypoint_head/: roi_keypoint_feature_extractors,
roi_keypoint_predictors, loss, inference). The module names are the
reference's (``conv_fcn1..8``, ``kps_score_lowres``), so Detectron and
maskrcnn-benchmark weights load by name.

* ``KeypointHead``: pooled [R, P, P, C] (NHWC) -> logits [R, K, 4P, 4P]
  (NCHW) in the compute dtype: 8 x (3x3 conv + ReLU), the 4x4 stride-2
  transposed conv, then the exact 2x bilinear upsample as the JAX head's
  shift-adds in the compute dtype.
* ``keypoints_to_heatmap``, ``keypoint_head_loss``,
  ``keypoints_within_box_filter``: the training pieces.
* ``heatmaps_to_keypoints``: the device decode (TPU.KEYPOINT_DECODE_ON_DEVICE),
  a 4x bilinear upsample and an argmax.
* ``heatmaps_to_keypoints_exact``: the host decode (the default), the
  reference's per-ROI bicubic resize to the ROI's size and argmax. The JAX
  package calls cv2.resize(INTER_CUBIC); ``resize_bicubic`` computes
  OpenCV's float32 bicubic in numpy (the card's machine has no OpenCV).
"""

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...utils import comm
from ..layers import Conv2d, ConvTranspose2d, init_conv_


class KeypointRCNNFeatureExtractor(nn.Module):
    def __init__(self, cfg, in_channels):
        super().__init__()
        cin = in_channels
        self.names = []
        for i, cout in enumerate(cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS, 1):
            self.names.append("conv_fcn{}".format(i))
            self.add_module(self.names[-1], Conv2d(cin, cout, 3, padding=1))
            cin = cout
        self.out_channels = cin

    def reset_parameters(self, gen):
        for name in self.names:
            init_conv_(getattr(self, name), gen, init="kaiming_normal_fanin")

    def forward(self, x):
        for name in self.names:
            x = F.relu(getattr(self, name)(x))
        return x


def upsample2x_bilinear(x):
    """The exact 2x bilinear upsample of [N, C, H, W] (align_corners=False)
    as the JAX head's shift-adds in x's dtype: even outputs 0.25 * prev +
    0.75 * cur, odd outputs 0.75 * cur + 0.25 * next, edges clamped; the
    rows first, then the columns."""

    def axis_up(v, dim):
        n = v.shape[dim]
        prev = torch.cat([v.narrow(dim, 0, 1), v.narrow(dim, 0, n - 1)], dim)
        nxt = torch.cat([v.narrow(dim, 1, n - 1), v.narrow(dim, n - 1, 1)], dim)
        even = 0.25 * prev + 0.75 * v
        odd = 0.75 * v + 0.25 * nxt
        shape = list(v.shape)
        shape[dim] *= 2
        return torch.stack([even, odd], dim + 1).reshape(shape)

    return axis_up(axis_up(x, 2), 3)


class KeypointRCNNPredictor(nn.Module):
    def __init__(self, cfg, in_channels):
        super().__init__()
        k = cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_CLASSES
        self.kps_score_lowres = ConvTranspose2d(in_channels, k, 4, stride=2, padding=1)

    def reset_parameters(self, gen):
        w = self.kps_score_lowres.weight
        fan_out = w.shape[1] * w.shape[2] * w.shape[3]
        with torch.no_grad():
            w.copy_(torch.randn(w.shape, generator=gen) * math.sqrt(2.0 / fan_out))
            self.kps_score_lowres.bias.zero_()

    def forward(self, x):
        return upsample2x_bilinear(self.kps_score_lowres(x))


class KeypointHead(nn.Module):
    def __init__(self, cfg, in_channels):
        super().__init__()
        h = cfg.MODEL.ROI_KEYPOINT_HEAD
        if (h.FEATURE_EXTRACTOR != "KeypointRCNNFeatureExtractor"
                or h.PREDICTOR != "KeypointRCNNPredictor"):
            raise NotImplementedError("keypoint head {} + {} is not ported".format(
                h.FEATURE_EXTRACTOR, h.PREDICTOR))
        self.feature_extractor = KeypointRCNNFeatureExtractor(cfg, in_channels)
        self.predictor = KeypointRCNNPredictor(cfg, self.feature_extractor.out_channels)

    def reset_parameters(self, gen):
        self.feature_extractor.reset_parameters(gen)
        self.predictor.reset_parameters(gen)

    def forward(self, pooled):
        """pooled [R, P, P, C] (NHWC) -> logits [R, K, 4P, 4P]."""
        return self.predictor(self.feature_extractor(pooled.permute(0, 3, 1, 2)))


# -- targets + loss ---------------------------------------------------------------


def keypoints_to_heatmap(keypoints, rois, heatmap_size):
    """keypoints [R, K, 3], rois [R, 4] -> (flat bin index [R, K] int64,
    valid [R, K]): floor((x - x1) * size / w), a joint on the ROI's right or
    bottom edge snapped to the last bin; valid where visible and in the
    window. The scale is a tensor-by-tensor division: a Python number over
    a tensor multiplies by the reciprocal, which can move a joint to the
    next bin."""
    size = torch.full_like(rois[:, 0:1], float(heatmap_size))
    scale_x = size / (rois[:, 2:3] - rois[:, 0:1]).clamp(min=1e-6)
    scale_y = size / (rois[:, 3:4] - rois[:, 1:2]).clamp(min=1e-6)
    x, y = keypoints[..., 0], keypoints[..., 1]
    xi = torch.floor((x - rois[:, 0:1]) * scale_x).long()
    yi = torch.floor((y - rois[:, 1:2]) * scale_y).long()
    xi = torch.where(x == rois[:, 2:3], heatmap_size - 1, xi)
    yi = torch.where(y == rois[:, 3:4], heatmap_size - 1, yi)
    valid = ((xi >= 0) & (yi >= 0) & (xi < heatmap_size) & (yi < heatmap_size)
             & (keypoints[..., 2] > 0))
    return (yi * heatmap_size + xi) * valid, valid


def keypoint_head_loss(kp_logits, keypoints, rois, roi_valid):
    """kp_logits [R, K, H, H]; keypoints [R, K, 3] of each ROI's matched
    gt; rois [R, 4]; roi_valid [R]: the cross-entropy of a spatial softmax
    over the H*H bins at the visible joints inside their ROIs, the mean
    over those (of the global batch in a process group)."""
    r, k, h, _ = kp_logits.shape
    targets, valid = keypoints_to_heatmap(keypoints, rois, h)
    valid = valid & roi_valid[:, None]
    logits = kp_logits.float().reshape(r, k, h * h)
    picked = torch.gather(logits, 2, targets[..., None])[..., 0]
    nll = torch.logsumexp(logits, 2) - picked
    return (nll * valid).sum() / comm.global_sum(valid.sum()).clamp(min=1)


def keypoints_within_box_filter(keypoints, gt_boxes):
    """[B, G]: whether an instance has a visible joint inside its gt box."""
    x, y = keypoints[..., 0], keypoints[..., 1]
    within = ((x >= gt_boxes[..., 0:1]) & (x <= gt_boxes[..., 2:3])
              & (y >= gt_boxes[..., 1:2]) & (y <= gt_boxes[..., 3:4]))
    return (within & (keypoints[..., 2] > 0)).any(-1)


# -- decodes ------------------------------------------------------------------------


def heatmaps_to_keypoints(kp_logits, rois):
    """The device decode: kp_logits [R, K, H, H], rois [R, 4] -> [R, K, 4]
    (x, y, 1, the logit at the maximum) on the image, from a 4x bilinear
    upsample (align_corners=False, edges clamped: jax.image.resize's
    bilinear) and the first maximum of each map."""
    r, k, h, _ = kp_logits.shape
    hu = 4 * h
    up = F.interpolate(kp_logits.float(), size=(hu, hu), mode="bilinear", align_corners=False)
    flat = up.reshape(r, k, hu * hu)
    idx = flat.argmax(-1)
    max_logit = torch.gather(flat, 2, idx[..., None])[..., 0]
    size = torch.full_like(rois[:, 0:1], float(hu))
    w = (rois[:, 2:3] - rois[:, 0:1]).clamp(min=1.0)
    hg = (rois[:, 3:4] - rois[:, 1:2]).clamp(min=1.0)
    x = rois[:, 0:1] + ((idx % hu).float() + 0.5) * (w / size)
    y = rois[:, 1:2] + ((idx // hu).float() + 0.5) * (hg / size)
    return torch.stack([x, y, torch.ones_like(max_logit), max_logit], -1)


_F = np.float32


def _cubic_weights(fx):
    """OpenCV's interpolateCubic (A = -0.75) in float32, its order of
    operations: fx [N] -> [N, 4]."""
    a, one = _F(-0.75), _F(1)
    x1, x2 = fx + one, one - fx
    c0 = ((a * x1 - _F(5) * a) * x1 + _F(8) * a) * x1 - _F(4) * a
    c1 = ((a + _F(2)) * fx - (a + _F(3))) * fx * fx + one
    c2 = ((a + _F(2)) * x2 - (a + _F(3))) * x2 * x2 + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], 1)


def _cubic_taps(dst, src):
    """OpenCV's four source indices (clamped to the edges) and weights of
    each of `dst` outputs resized from `src` pixels: the source position
    (d + 0.5) * scale - 0.5 in double, rounded to float, its floor and
    fraction."""
    scale = 1.0 / (float(dst) / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    w = _cubic_weights((f - s).astype(np.float32))
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3), 0, src - 1)
    return idx, w


def _horizontal(src, xi, xw):
    rows = src[:, xi[:, 0]] * xw[:, 0, None]
    for j in range(1, 4):
        rows = rows + src[:, xi[:, j]] * xw[:, j, None]
    return rows


def _taps_sum(weights, values):
    """sum_j weights[..., j] * values[j], left to right in float32."""
    out = weights[..., 0] * values[0]
    for j in range(1, 4):
        out = out + weights[..., j] * values[j]
    return out


def resize_bicubic(src, width, height):
    """cv2.resize(src, (width, height), interpolation=cv2.INTER_CUBIC) for a
    float32 [h, w, C] image, as OpenCV computes it: a horizontal pass over
    the source rows, then a vertical pass, each output the sum of its four
    taps in float32; the same size is a copy. Vectorised over the pixels:
    four gathers a pass."""
    src = np.asarray(src, np.float32)
    h, w = src.shape[:2]
    if (width, height) == (w, h):
        return src.copy()
    xi, xw = _cubic_taps(width, w)
    yi, yw = _cubic_taps(height, h)
    rows = _horizontal(src, xi, xw)
    return _taps_sum(yw[:, None, None, :], [rows[yi[:, j]] for j in range(4)])


def _corners(lo_a, hi_a, lo_b, hi_b):
    """The least and largest products of two intervals, elementwise."""
    p = np.stack([lo_a * lo_b, lo_a * hi_b, hi_a * lo_b, hi_a * hi_b])
    return p.min(0), p.max(0)


def resized_maxima(src, width, height):
    """(flat position [C], value [C]) of the first maximum of each channel of
    resize_bicubic(src, width, height), without the whole resized map.

    The outputs between two source rows and two source columns (a block)
    share their 4 x 4 taps S_ij, so each is sum_ij wy_i wx_j S_ij with
    weights inside the block's extremes. Written as (sum wy)(sum wx) M +
    sum_ij wy_i wx_j (S_ij - M), M the largest inner tap, that bounds every
    output of the block from above; with a margin for float32's rounding
    (4e-6 of sum |wy_i wx_j S_ij|, over 4x the worst case) the bound holds
    for the float32 sums too. Only the blocks whose bound reaches a value
    the map attains (each block's first output) are summed pixel by pixel,
    with the same products and sums, in the same order, as resize_bicubic."""
    src = np.asarray(src, np.float32)
    h, w, c = src.shape
    if width * height <= 4 * h * w or (width, height) == (w, h):
        flat = resize_bicubic(src, width, height).reshape(-1, c)
        pos = flat.argmax(0)
        return pos, flat[pos, np.arange(c)]
    xi, xw = _cubic_taps(width, w)
    yi, yw = _cubic_taps(height, h)
    sx = np.flatnonzero(np.r_[True, (xi[1:] != xi[:-1]).any(1)])
    sy = np.flatnonzero(np.r_[True, (yi[1:] != yi[:-1]).any(1)])
    nx, ny = np.diff(np.r_[sx, width]), np.diff(np.r_[sy, height])
    blk = src[yi[sy][:, None, :, None], xi[sx][None, :, None, :]]  # [Gy, Gx, 4, 4, C]
    # a lower bound of each channel's maximum: the blocks' first outputs
    first = _horizontal(src, xi[sx], xw[sx])  # [h, Gx, C]
    lower = _taps_sum(yw[sy][:, None, None, :], [first[yi[sy, i]] for i in range(4)])
    lower = lower.reshape(-1, c).max(0)
    wy, wx = yw.astype(np.float64), xw.astype(np.float64)
    ylo, yhi = np.minimum.reduceat(wy, sy, 0), np.maximum.reduceat(wy, sy, 0)
    xlo, xhi = np.minimum.reduceat(wx, sx, 0), np.maximum.reduceat(wx, sx, 0)
    plo, phi = _corners(ylo[:, None, :, None], yhi[:, None, :, None],
                        xlo[None, :, None, :], xhi[None, :, None, :])  # [Gy, Gx, 4, 4]
    slo, shi = _corners(np.minimum.reduceat(wy.sum(1), sy)[:, None],
                        np.maximum.reduceat(wy.sum(1), sy)[:, None],
                        np.minimum.reduceat(wx.sum(1), sx)[None, :],
                        np.maximum.reduceat(wx.sum(1), sx)[None, :])  # [Gy, Gx]
    b64 = blk.astype(np.float64)
    m = b64[:, :, 1:3, 1:3].max((2, 3))
    d = b64 - m[:, :, None, None]
    upper = np.maximum(phi[..., None] * d, plo[..., None] * d).sum((2, 3))
    upper += np.maximum(shi[..., None] * m, slo[..., None] * m)
    margin = (np.maximum(np.abs(plo), np.abs(phi))[..., None] * np.abs(b64)).sum((2, 3))
    gy, gx, k = np.nonzero(upper + 4e-6 * margin >= lower)
    # every output of those blocks, as resize_bicubic sums it
    dy = sy[gy][:, None] + np.arange(ny[gy].max())
    dx = sx[gx][:, None] + np.arange(nx[gx].max())
    inside = ((dy < (sy[gy] + ny[gy])[:, None])[:, :, None]
              & (dx < (sx[gx] + nx[gx])[:, None])[:, None, :])
    dy, dx = np.minimum(dy, height - 1), np.minimum(dx, width - 1)
    taps = blk[gy, gx, :, :, k]  # [n, 4, 4]
    across = _taps_sum(xw[dx][:, None], [taps[:, :, j, None] for j in range(4)])  # [n, 4, NX]
    vals = _taps_sum(yw[dy][:, :, None], [across[:, None, i] for i in range(4)])  # [n, NY, NX]
    vals = np.where(inside, vals, -np.inf)
    best = np.full(c, -np.inf, np.float32)
    np.maximum.at(best, k, vals.reshape(len(k), -1).max(1))
    at = vals == best[k][:, None, None]
    flat = dy[:, :, None] * width + dx[:, None, :]
    pos = np.full(c, height * width, np.int64)
    np.minimum.at(pos, np.broadcast_to(k[:, None, None], at.shape)[at], flat[at])
    return pos, best


def heatmaps_to_keypoints_exact(maps, rois):
    """The host decode of the reference (keypoint_head/inference.py): per
    ROI, the [H, H, K] heatmap resized bicubically to the ROI's size rounded
    up, the first maximum of each joint's map, mapped back to the image at
    the pixel's centre. maps [R, H, H, K] float32 (NHWC), rois [R, 4]
    (numpy) -> [R, K, 4] (x, y, 1, the value at the maximum)."""
    maps = np.asarray(maps, np.float32)
    rois = np.asarray(rois, np.float32)
    r, _, _, k = maps.shape
    out = np.zeros((r, k, 4), np.float32)
    widths = np.maximum(rois[:, 2] - rois[:, 0], 1)
    heights = np.maximum(rois[:, 3] - rois[:, 1], 1)
    wc = np.ceil(widths).astype(int)
    hc = np.ceil(heights).astype(int)
    for i in range(r):
        pos, value = resized_maxima(maps[i], wc[i], hc[i])
        x_int = pos % wc[i]
        y_int = (pos - x_int) // wc[i]
        out[i, :, 0] = (x_int + 0.5) * (widths[i] / wc[i]) + rois[i, 0]
        out[i, :, 1] = (y_int + 0.5) * (heights[i] / hc[i]) + rois[i, 1]
        out[i, :, 2] = 1.0
        out[i, :, 3] = value
    return out
