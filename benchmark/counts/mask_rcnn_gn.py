"""The work of one step of GN Mask R-CNN R-50-FPN with the Xconv1fc box head
(the configuration mask_rcnn_R_50_FPN_Xconv1fc_1x_gn names it as its
"counts"), counted from the configuration and the cell's shapes.

* "flops": model FLOPs by flops.py's rules (2 a multiply-add; a trainable
  conv's or fc's weight gradient, and its input gradient where its input
  carries one): the body with the stride where STRIDE_IN_1X1 puts it (in
  the 3x3 conv here; flops.py puts it in the 1x1), the FPN and RPN head as
  flops.py counts them, the Xconv box head (NUM_STACKED_CONVS 3x3 convs of
  CONV_HEAD_DIM over the ROIs at POOLER_RESOLUTION, fc6 from CONV_HEAD_DIM x
  P^2 to MLP_HEAD_DIM, the predictor), the mask head as flops.py counts it;
  and each group norm's elementwise work, GN_FWD_FLOPS an element forward
  (mean, centre, square, variance, normalise, scale, shift) and
  GN_BWD_FLOPS backward (the gradients of scale and shift, dx from the two
  group sums);
* "pooler_bound_s", "nms_matcher_bound_s" (training) or "nms_bound_s"
  (inference), as counts/mask_rcnn_r50.py gives them;
* "gn_bound_s": the least seconds of every group norm of the step, by the
  shape of its input: forward x in and y out, and, for each call outside
  the frozen stem and stages, backward x and dy in and dx out, in the
  compute dtype at 3.35 TB/s (roofline.py); the statistics and the
  per-channel parameters (bytes a group or a channel) are left out. It
  counts the work, not an implementation, so a fused kernel is judged
  against the same figure;
* "gn_calls", "gn_calls_bwd": the group norms a step and those with a
  backward (69 and 58 at FREEZE_CONV_BODY_AT 2: the stem's and res2's 11
  are frozen).
"""

from . import flops, mask_rcnn_r50, roofline

GN_FWD_FLOPS = 7
GN_BWD_FLOPS = 11


class Step(flops.Count):
    """flops.Count with the group norms of the step: `norms`, (elements,
    with a backward) a call."""

    def __init__(self, train):
        super().__init__(train)
        self.norms = []

    def norm(self, numel, trainable):
        backward = self.train and trainable
        self.norms.append((numel, backward))
        self.fwd += GN_FWD_FLOPS * numel
        self.bwd += GN_BWD_FLOPS * numel if backward else 0


def _body(s, cfg, b, hw, freeze):
    """The GN stem and stages of R-50 -> [(channels, h, w, carries a
    gradient)] of C2-C5."""
    r = cfg["MODEL"]["RESNETS"]
    stem = r["STEM_OUT_CHANNELS"]
    f, h, w = flops._conv(b, 3, stem, 7, hw[0], hw[1], 2, 3)
    s.op(f, freeze < 1, False)
    s.norm(b * stem * h * w, freeze < 1)
    h, w = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1
    out2, width = r["RES2_OUT_CHANNELS"], r["NUM_GROUPS"] * r["WIDTH_PER_GROUP"]
    maps, cin, grad = [], stem, freeze < 1
    for i, blocks in enumerate((3, 4, 6, 3), start=1):
        trainable = freeze < i + 1
        mid, cout = width * 2 ** (i - 1), out2 * 2 ** (i - 1)
        for k in range(blocks):
            stride = (1 if i == 1 else 2) if k == 0 else 1
            s1, s2 = (stride, 1) if r["STRIDE_IN_1X1"] else (1, stride)
            into = grad if k == 0 else trainable
            f, h1, w1 = flops._conv(b, cin, mid, 1, h, w, s1, 0)
            s.op(f, trainable, into)
            s.norm(b * mid * h1 * w1, trainable)
            f, h2, w2 = flops._conv(b, mid, mid, 3, h1, w1, s2, 1)
            s.op(f, trainable, trainable)
            s.norm(b * mid * h2 * w2, trainable)
            f, h3, w3 = flops._conv(b, mid, cout, 1, h2, w2, 1, 0)
            s.op(f, trainable, trainable)
            s.norm(b * cout * h3 * w3, trainable)
            if cin != cout:
                s.op(flops._conv(b, cin, cout, 1, h, w, stride, 0)[0], trainable, into)
                s.norm(b * cout * h3 * w3, trainable)
            h, w, cin = h3, w3, cout
        grad = grad or trainable
        maps.append((cout, h, w, grad))
    return maps


def step(cfg, batch, hw, train):
    """The Step of one step of `batch` images padded to hw."""
    m = cfg["MODEL"]
    freeze = m["BACKBONE"]["FREEZE_CONV_BODY_AT"] if train else 99
    s = Step(train)
    b = batch
    maps = _body(s, cfg, b, hw, freeze)
    d = m["RESNETS"]["BACKBONE_OUT_CHANNELS"]
    levels = []
    for ci, hi, wi, gi in maps:
        s.op(flops._conv(b, ci, d, 1, hi, wi)[0], train, gi)
        s.norm(b * d * hi * wi, True)
        s.op(flops._conv(b, d, d, 3, hi, wi)[0], train, True)
        s.norm(b * d * hi * wi, True)
        levels.append((hi, wi))
    levels.append(((levels[-1][0] + 1) // 2, (levels[-1][1] + 1) // 2))
    a = len(m["RPN"]["ASPECT_RATIOS"])
    for hi, wi in levels:
        s.op(flops._conv(b, d, d, 3, hi, wi)[0], train, True)
        s.op(flops._conv(b, d, 5 * a, 1, hi, wi)[0], train, True)

    h_, bh, mh = m["ROI_HEADS"], m["ROI_BOX_HEAD"], m["ROI_MASK_HEAD"]
    classes = bh["NUM_CLASSES"]
    if train:
        rois = b * h_["BATCH_SIZE_PER_IMAGE"]
        masks = b * min(int(h_["BATCH_SIZE_PER_IMAGE"] * h_["POSITIVE_FRACTION"]),
                        cfg["TPU"]["MASK_ROI_CAP"])
    else:
        rois = b * m["RPN"]["FPN_POST_NMS_TOP_N_TEST"]
        masks = b * h_["DETECTIONS_PER_IMG"]
    p, cin = bh["POOLER_RESOLUTION"], d
    for _ in range(bh["NUM_STACKED_CONVS"]):
        s.op(flops._conv(rois, cin, bh["CONV_HEAD_DIM"], 3, p, p)[0], train, train)
        cin = bh["CONV_HEAD_DIM"]
        s.norm(rois * cin * p * p, True)
    dim = bh["MLP_HEAD_DIM"]
    s.op(2 * rois * cin * p * p * dim, train, train)
    s.op(2 * rois * dim * classes, train, train)
    s.op(2 * rois * dim * classes * 4, train, train)

    pm, cin = mh["POOLER_RESOLUTION"], d
    for cout in mh["CONV_LAYERS"]:
        s.op(flops._conv(masks, cin, cout, 3, pm, pm)[0], train, train)
        s.norm(masks * cout * pm * pm, True)
        cin = cout
    dred = mh["CONV_LAYERS"][-1]
    s.op(2 * masks * pm * pm * cin * dred * 4, train, train)  # the 2x2 deconv
    s.op(2 * masks * (2 * pm) ** 2 * dred * (1 if train else classes), train, train)
    return s


def gn_bytes(cfg, norms):
    """Bytes of the group norms `norms` ((elements, with a backward) a
    call): x in and y out, and x, dy in and dx out for a backward."""
    e = roofline.ELEMENT[cfg["TPU"]["COMPUTE_DTYPE"]]
    return sum(n * e * (2 + (3 if backward else 0)) for n, backward in norms)


def step_counts(cfg, batch, hw, train):
    """Per step of `batch` images padded to hw: "flops", the pooler and NMS
    bounds of mask_rcnn_r50.py, "gn_bound_s", "gn_calls" and
    "gn_calls_bwd"."""
    s = step(cfg, batch, hw, train)
    out = {k: v for k, v in mask_rcnn_r50.step_counts(cfg, batch, hw, train).items()
           if k != "flops"}
    out.update(flops=s.fwd + s.bwd, gn_bound_s=roofline.bound_s(gn_bytes(cfg, s.norms)),
               gn_calls=len(s.norms), gn_calls_bwd=sum(bwd for _, bwd in s.norms))
    return out
