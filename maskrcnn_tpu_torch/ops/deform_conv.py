"""Deformable convolution v1/v2 and deformable PS-ROI pooling, NHWC.

PyTorch counterpart of maskrcnn_tpu/ops/deform_conv.py, which computes both
in plain jnp (maskrcnn-benchmark's CUDA kernels have no counterpart among
the TPU kernels), so this is plain tensor code too:

* ``deform_conv2d``: for every output position and kernel tap the input is
  sampled bilinearly at the tap's position plus its learned (y, x) offset
  (deformable-group major), in float32, a sample being zero when y <= -1,
  y >= H, x <= -1 or x >= W and each of its four corners counting only
  inside the map (no half-pixel shift); v2 multiplies each tap by its
  modulation mask. The columns [B, OH, OW, K*K, Cin], cast to the compute
  dtype, are contracted with the kernel by one matrix product (per group).
* ``deform_psroi_pool``: position-sensitive ROI pooling whose bins average
  a sub-grid of samples, shifted by learned offsets (or not, no_trans).

The sampling is an autograd Function that keeps only its inputs and
recomputes the four corners in its backward: the corners of a layer2 conv
of the R-50 body are 77 MB an image each in float32, and autograd through
the plain expression would keep all four (and the weighted sum) for every
deformable block. Its gradients are those of the JAX expression: to the
input, each corner's weight (index_add_ into the rows it read); to the
offsets, the derivative of the bilinear weights; to the mask, the sample.
"""

import torch


def _corner_rows(y0, x0, dy, dx, h, w, base):
    """Row of the flat [B*H*W, C] map each sample's corner (dy, dx) reads,
    and whether that corner lies inside the map."""
    yi, xi = y0 + dy, x0 + dx
    valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    rows = base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
    return rows.reshape(-1), valid


class _DeformSample(torch.autograd.Function):
    """x [B, H, W, C] float32, y, xq [B, OH, OW, T] float32 coordinates,
    mask [B, OH, OW, T] or None -> [B, OH, OW, T, C] float32.

    The forward rounds as the JAX expression does: each corner times its
    row weight, then its column weight, the four summed in order, then the
    mask. Whether a corner counts (inside the map, the sample inside
    [-1, H] x [-1, W]) is a 0/1 factor folded into the row weight on the
    small [B, OH, OW, T] grid, which changes no bit. The backward folds all
    of a corner's factors into one weight, so each corner costs one gather,
    one product with the gradient and one index_add_."""

    @staticmethod
    def _corners(x, y, xq):
        """(rows, row weight times whether the corner counts, column weight,
        whether it counts) of each corner, and the fractional parts."""
        b, h, w, _ = x.shape
        inside = ~((y <= -1.0) | (y >= h) | (xq <= -1.0) | (xq >= w))
        y0, x0 = torch.floor(y), torch.floor(xq)
        wy, wx = y - y0, xq - x0
        y0, x0 = y0.long(), x0.long()
        base = (torch.arange(b, device=x.device) * (h * w)).view(b, 1, 1, 1)
        out = []
        for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            rows, valid = _corner_rows(y0, x0, dy, dx, h, w, base)
            seen = (valid & inside).to(x.dtype)
            out.append((rows, (wy if dy else 1 - wy) * seen, wx if dx else 1 - wx, seen))
        return out, wy, wx

    @staticmethod
    def forward(ctx, x, y, xq, mask):
        b, h, w, c = x.shape
        flat = x.reshape(b * h * w, c)
        corners, _, _ = _DeformSample._corners(x, y, xq)
        val = None
        for rows, a, e, _ in corners:
            v = flat.index_select(0, rows).view(*y.shape, c)
            v.mul_(a[..., None]).mul_(e[..., None])
            val = v if val is None else val.add_(v)
        if mask is not None:
            val.mul_(mask[..., None])
        ctx.save_for_backward(x, y, xq, mask)
        return val

    @staticmethod
    def backward(ctx, grad):
        x, y, xq, mask = ctx.saved_tensors
        b, h, w, c = x.shape
        flat = x.reshape(b * h * w, c)
        corners, wy, wx = _DeformSample._corners(x, y, xq)
        gx = torch.zeros_like(flat) if ctx.needs_input_grad[0] else None
        dots = []  # <grad, corner> over the channels where the corner counts
        for rows, a, e, seen in corners:
            v = flat.index_select(0, rows).view(*y.shape, c)
            dots.append((grad * v).sum(-1) * seen)
            del v
            if gx is not None:
                wv = a * e if mask is None else a * e * mask
                gx.index_add_(0, rows, (grad * wv[..., None]).reshape(-1, c))
        d00, d01, d10, d11 = dots
        gmask = None
        if mask is not None:
            if ctx.needs_input_grad[3]:
                gmask = (d00 * (1 - wy) * (1 - wx) + d01 * (1 - wy) * wx
                         + d10 * wy * (1 - wx) + d11 * wy * wx)
            d00, d01, d10, d11 = (d * mask for d in dots)
        gy = (d10 - d00) * (1 - wx) + (d11 - d01) * wx
        gxq = (d01 - d00) * (1 - wy) + (d11 - d10) * wy
        return (None if gx is None else gx.view(b, h, w, c), gy, gxq, gmask)


def _out_size(size, k, stride, padding, dilation):
    return (size + 2 * padding - dilation * (k - 1) - 1) // stride + 1


def deform_conv2d(x, offsets, weight, mask=None, stride=1, padding=1, dilation=1, groups=1,
                  deformable_groups=1, compute_dtype=torch.bfloat16):
    """x [B, H, W, Cin] (NHWC); offsets [B, OH, OW, 2 * G * K * K], (y, x)
    per tap, deformable group major; weight [Cout, Cin / groups, K, K]
    (OIHW); mask [B, OH, OW, G * K * K], the modulation (v2) after its
    sigmoid, or None (v1). Returns [B, OH, OW, Cout] in compute_dtype."""
    b, h, w, cin = x.shape
    cout, k = weight.shape[0], weight.shape[-1]
    g = deformable_groups
    oh = _out_size(h, k, stride, padding, dilation)
    ow = _out_size(w, k, stride, padding, dilation)
    dev = x.device
    oy = torch.arange(oh, dtype=torch.float32, device=dev) * stride - padding
    ox = torch.arange(ow, dtype=torch.float32, device=dev) * stride - padding
    kk = torch.arange(k, dtype=torch.float32, device=dev) * dilation
    # base tap positions [OH, OW, K*K], tap t = ky * K + kx
    base_y = (oy[:, None, None, None] + kk[None, None, :, None]).expand(oh, ow, k, k)
    base_x = (ox[None, :, None, None] + kk[None, None, None, :]).expand(oh, ow, k, k)
    base_y, base_x = base_y.reshape(oh, ow, k * k), base_x.reshape(oh, ow, k * k)

    off = offsets.float().reshape(b, oh, ow, g, k * k, 2)
    ys = base_y[None, :, :, None, :] + off[..., 0]  # [B, OH, OW, G, K*K]
    xs = base_x[None, :, :, None, :] + off[..., 1]
    m = None if mask is None else mask.float().reshape(b, oh, ow, g, k * k)
    cg = cin // g
    xf = x.float()
    cols = [_DeformSample.apply(xf[..., gi * cg:(gi + 1) * cg].contiguous(),
                                ys[:, :, :, gi].contiguous(), xs[:, :, :, gi].contiguous(),
                                None if m is None else m[:, :, :, gi].contiguous())
            for gi in range(g)]
    cols = (torch.cat(cols, dim=-1) if g > 1 else cols[0]).to(compute_dtype)
    # [K*K, Cin / groups, Cout]: the kernel's taps in the columns' order
    wmat = weight.to(compute_dtype).permute(2, 3, 1, 0).reshape(k * k, cin // groups, cout)
    if groups == 1:
        out = cols.reshape(b * oh * ow, k * k * cin) @ wmat.reshape(k * k * cin, cout)
        return out.view(b, oh, ow, cout)
    cg2, og = cin // groups, cout // groups
    parts = [cols[..., gi * cg2:(gi + 1) * cg2].reshape(b * oh * ow, k * k * cg2)
             @ wmat[:, :, gi * og:(gi + 1) * og].reshape(k * k * cg2, og)
             for gi in range(groups)]
    return torch.cat(parts, dim=-1).view(b, oh, ow, cout)


def deform_psroi_pool(features, rois, roi_batch_idx, offsets, spatial_scale, out_size,
                      sample_per_part=4, trans_std=0.1):
    """features [B, H, W, C], rois [R, 4] xyxy image coordinates,
    roi_batch_idx [R], offsets [R, P, P, 2] (normalized (y, x)) or None
    (no_trans) -> [R, P, P, C]: each bin the mean of its valid samples on an
    s x s sub-grid (s = sample_per_part), shifted by offset * trans_std *
    the ROI's size. The ROI is rounded and grown by half a cell a side."""
    b, h, w, c = features.shape
    r, p, s = rois.shape[0], out_size, sample_per_part
    dev = features.device
    boxes = rois.float() * spatial_scale
    x1 = torch.round(boxes[:, 0]) - 0.5
    y1 = torch.round(boxes[:, 1]) - 0.5
    x2 = torch.round(boxes[:, 2]) + 0.5
    y2 = torch.round(boxes[:, 3]) + 0.5
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bin_w, bin_h = rw / p, rh / p

    idx = torch.arange(p * s, device=dev)
    cell = (idx // s).float()[None, :]
    sub = (idx % s).float()[None, :]
    ys = y1[:, None] + cell * bin_h[:, None] + (sub + 0.5) * (bin_h[:, None] / s)
    xs = x1[:, None] + cell * bin_w[:, None] + (sub + 0.5) * (bin_w[:, None] / s)
    yq = ys[:, :, None].expand(r, p * s, p * s)
    xq = xs[:, None, :].expand(r, p * s, p * s)
    if offsets is not None:
        dy = offsets[..., 0] * trans_std * rh[:, None, None]
        dx = offsets[..., 1] * trans_std * rw[:, None, None]
        yq = yq + dy.repeat_interleave(s, 1).repeat_interleave(s, 2)
        xq = xq + dx.repeat_interleave(s, 1).repeat_interleave(s, 2)

    flat = features.reshape(b * h * w, c)
    base = roi_batch_idx.long()[:, None, None] * (h * w)
    outside = (yq < -0.5) | (yq > h - 0.5) | (xq < -0.5) | (xq > w - 0.5)
    yc = yq.clamp(0.0, h - 1.0)
    xc = xq.clamp(0.0, w - 1.0)
    y0 = torch.floor(yc).long()
    x0 = torch.floor(xc).long()
    y1i = (y0 + 1).clamp(max=h - 1)
    x1i = (x0 + 1).clamp(max=w - 1)
    wy = (yc - y0)[..., None]
    wx = (xc - x0)[..., None]

    def take(yy, xx):
        return flat.index_select(0, (base + yy * w + xx).reshape(-1)).view(r, p * s, p * s, c)

    val = ((1 - wy) * (1 - wx) * take(y0, x0) + (1 - wy) * wx * take(y0, x1i)
           + wy * (1 - wx) * take(y1i, x0) + wy * wx * take(y1i, x1i))
    val = torch.where(outside[..., None], torch.zeros((), device=dev), val)
    valid = (~outside).float()[..., None]
    val = val.reshape(r, p, s, p, s, c).sum(dim=(2, 4))
    count = valid.reshape(r, p, s, p, s, 1).sum(dim=(2, 4))
    return val / torch.clamp(count, min=1.0)
