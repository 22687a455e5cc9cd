"""ROIPool (max pooling over integer-rounded ROIs), NHWC.

PyTorch counterpart of ``roi_pool`` in maskrcnn_tpu/ops/roi_align.py (after
the reference csrc/cuda/ROIPool_cuda.cu:17-79). The port's ROIAlign lives in
models/poolers.py; no model path calls ROIPool, so it is plain tensor code,
as in the JAX package, and autograd gives its backward: the gradient goes to
each bin's maximum (split evenly among tied maxima, as jnp.max's).
"""

import torch

_NEG = -3.4e38


def roi_pool(features, rois, roi_batch_idx, output_size, spatial_scale):
    """features [B, H, W, C], rois [K, 4] xyxy image coordinates,
    roi_batch_idx [K] -> [K, PH, PW, C]. The ROI is rounded to whole cells
    (at least 1 x 1), bin (i, j) covers cells [floor(i * bin), ceil((i + 1)
    * bin)) from the ROI's corner, clipped to the map, and a bin that
    covers no cell of the map is 0."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    ph, pw = output_size
    b, h, w, c = features.shape
    k = rois.shape[0]
    dev = features.device

    r = torch.round(rois.float() * spatial_scale)
    x1, y1 = r[:, 0], r[:, 1]
    bin_w = torch.clamp(r[:, 2] - x1 + 1.0, min=1.0) / pw
    bin_h = torch.clamp(r[:, 3] - y1 + 1.0, min=1.0) / ph

    # every cell a bin could cover: at most ceil(H / PH) + 1 an axis
    cap_h, cap_w = -(-h // ph) + 1, -(-w // pw) + 1
    py = torch.arange(ph, dtype=torch.float32, device=dev)[None, :, None]
    px = torch.arange(pw, dtype=torch.float32, device=dev)[None, :, None]
    hstart = torch.floor(py * bin_h[:, None, None]) + y1[:, None, None]
    hend = torch.ceil((py + 1) * bin_h[:, None, None]) + y1[:, None, None]
    wstart = torch.floor(px * bin_w[:, None, None]) + x1[:, None, None]
    wend = torch.ceil((px + 1) * bin_w[:, None, None]) + x1[:, None, None]
    ys = hstart + torch.arange(cap_h, dtype=torch.float32, device=dev)  # [K, PH, cap_h]
    xs = wstart + torch.arange(cap_w, dtype=torch.float32, device=dev)  # [K, PW, cap_w]
    ys_valid = (ys < hend) & (ys >= 0) & (ys < h)
    xs_valid = (xs < wend) & (xs >= 0) & (xs < w)
    yi = ys.clamp(0, h - 1).long()
    xi = xs.clamp(0, w - 1).long()

    base = (roi_batch_idx.long() * (h * w))[:, None, None, None, None]
    lin = base + yi[:, :, None, :, None] * w + xi[:, None, :, None, :]
    # index_select: its backward is index_add_ on the rows
    vals = features.reshape(b * h * w, c).index_select(0, lin.reshape(-1))
    vals = vals.reshape(k, ph, pw, cap_h, cap_w, c)
    valid = (ys_valid[:, :, None, :, None] & xs_valid[:, None, :, None, :])[..., None]
    vals = torch.where(valid, vals, torch.full((), _NEG, dtype=vals.dtype, device=dev))
    out = torch.amax(vals, dim=(3, 4))
    return torch.where(valid.any(dim=(3, 4)), out, torch.zeros((), dtype=out.dtype, device=dev))
