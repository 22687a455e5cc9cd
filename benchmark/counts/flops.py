"""The model's FLOPs of one step, counted from the configuration and the
cell's shapes: the convolutions and matrix products of the model as
published, whatever implements them, the same for every version of the
program.

Counted (2 FLOPs a multiply-add):
* the body (ResNet-50 to C4 or C5), the FPN (laterals, outputs), the RPN
  head (its 3x3 conv and its two 1x1 convs) over every map;
* the box head over its ROIs: in training the sampled batch,
  BATCH_SIZE_PER_IMAGE an image; at inference the proposals,
  FPN_POST_NMS_TOP_N_TEST (FPN) or POST_NMS_TOP_N_TEST (C4) an image;
* the mask head over its ROIs: in training the positives at the batch-wide
  cap the step computes, min(BATCH_SIZE_PER_IMAGE * POSITIVE_FRACTION,
  TPU.MASK_ROI_CAP) an image, and the one class's 1x1 logits of each; at
  inference DETECTIONS_PER_IMG an image and the 1x1 logits of every class;
  a C4 mask head runs the shared res5 head over its own ROIs first.
* backward: for each trainable conv or fc its weight gradient, and its
  input gradient where its input carries a gradient (not for the first
  trainable stage's inputs, which come from frozen stages); no
  recomputation.

Not counted: ROI pooling, NMS, matching, sampling, losses, elementwise work
and the optimizer (no multiply-adds of a product).
"""


def _conv(b, cin, cout, k, h, w, stride=1, pad=None, groups=1):
    """(forward FLOPs, output h, output w) of a conv on [b, cin, h, w]."""
    pad = k // 2 if pad is None else pad
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    return 2 * b * ho * wo * cout * (cin // groups) * k * k, ho, wo


class Count:
    """Forward and, in training, backward FLOPs, summed op by op."""

    def __init__(self, train):
        self.train = train
        self.fwd = 0
        self.bwd = 0

    def op(self, flops, trainable, input_grad):
        self.fwd += flops
        if self.train:
            self.bwd += flops * (int(trainable) + int(input_grad))


def _bottleneck(c, b, cin, width, cout, h, w, stride, trainable, input_grad):
    """One bottleneck (stride in the 1x1, as STRIDE_IN_1X1); -> (h, w)."""
    f, h1, w1 = _conv(b, cin, width, 1, h, w, stride, 0)
    c.op(f, trainable, input_grad)
    f, h2, w2 = _conv(b, width, width, 3, h1, w1, 1, 1)
    c.op(f, trainable, trainable)
    f, h3, w3 = _conv(b, width, cout, 1, h2, w2, 1, 0)
    c.op(f, trainable, trainable)
    if cin != cout:
        f, _, _ = _conv(b, cin, cout, 1, h, w, stride, 0)
        c.op(f, trainable, input_grad)
    return h3, w3


def _res_stage(c, b, cin, width, cout, blocks, h, w, stride, trainable, input_grad):
    for k in range(blocks):
        h, w = _bottleneck(c, b, cin if k == 0 else cout, width, cout, h, w,
                           stride if k == 0 else 1, trainable, input_grad if k == 0 else trainable)
    return h, w


def step_flops(cfg, batch, hw, train):
    """(forward, backward) FLOPs of one step at `batch` images padded to hw
    (backward 0 at inference)."""
    m = cfg["MODEL"]
    r = m["RESNETS"]
    fpn = "FPN" in m["BACKBONE"]["CONV_BODY"]
    freeze = m["BACKBONE"]["FREEZE_CONV_BODY_AT"] if train else 99
    c = Count(train)
    b = batch
    f, h, w = _conv(b, 3, r["STEM_OUT_CHANNELS"], 7, hw[0], hw[1], 2, 3)
    c.op(f, freeze < 1, False)
    h, w = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1
    out2, width = r["RES2_OUT_CHANNELS"], r["NUM_GROUPS"] * r["WIDTH_PER_GROUP"]
    stages = 4 if fpn else 3
    maps, cin, grad = [], r["STEM_OUT_CHANNELS"], freeze < 1
    for i in range(1, stages + 1):
        trainable = freeze < i + 1
        h, w = _res_stage(c, b, cin, width * 2 ** (i - 1), out2 * 2 ** (i - 1), (3, 4, 6, 3)[i - 1],
                          h, w, 1 if i == 1 else 2, trainable, grad)
        grad = grad or trainable
        cin = out2 * 2 ** (i - 1)
        maps.append((cin, h, w, grad))
    d = r["BACKBONE_OUT_CHANNELS"]
    a = len(m["RPN"]["ASPECT_RATIOS"]) * (1 if fpn else len(m["RPN"]["ANCHOR_SIZES"]))
    if fpn:
        levels = []
        for ci, hi, wi, gi in maps:
            c.op(_conv(b, ci, d, 1, hi, wi)[0], train, gi)
            c.op(_conv(b, d, d, 3, hi, wi)[0], train, True)
            levels.append((hi, wi))
        levels.append(((levels[-1][0] + 1) // 2, (levels[-1][1] + 1) // 2))
    else:
        levels = [maps[-1][1:3]]
    for hi, wi in levels:
        c.op(_conv(b, d, d, 3, hi, wi)[0], train, True)
        c.op(_conv(b, d, 5 * a, 1, hi, wi)[0], train, True)

    h_ = m["ROI_HEADS"]
    bh, mh = m["ROI_BOX_HEAD"], m["ROI_MASK_HEAD"]
    classes = bh["NUM_CLASSES"]
    if train:
        rois = b * h_["BATCH_SIZE_PER_IMAGE"]
        masks = b * min(int(h_["BATCH_SIZE_PER_IMAGE"] * h_["POSITIVE_FRACTION"]),
                        cfg["TPU"]["MASK_ROI_CAP"])
    else:
        rois = b * (m["RPN"]["FPN_POST_NMS_TOP_N_TEST"] if fpn else m["RPN"]["POST_NMS_TOP_N_TEST"])
        masks = b * h_["DETECTIONS_PER_IMG"]
    p = bh["POOLER_RESOLUTION"]
    if bh["FEATURE_EXTRACTOR"] == "FPN2MLPFeatureExtractor":
        dim = bh["MLP_HEAD_DIM"]
        c.op(2 * rois * d * p * p * dim, train, train)
        c.op(2 * rois * dim * dim, train, train)
        head_out = dim
    else:
        _res5(c, rois, r, p, train)
        head_out = out2 * 8
    c.op(2 * rois * head_out * classes, train, train)
    c.op(2 * rois * head_out * classes * 4, train, train)

    pm = mh["POOLER_RESOLUTION"]
    dred = mh["CONV_LAYERS"][-1]
    if mh["SHARE_BOX_FEATURE_EXTRACTOR"]:
        mp = _res5(c, masks, r, pm, train)
        cin_m = out2 * 8
    else:
        cin_m, mp = d, pm
        for cout in mh["CONV_LAYERS"]:
            c.op(_conv(masks, cin_m, cout, 3, mp, mp)[0], train, train)
            cin_m = cout
    # the deconv: every input cell times the 2x2 kernel into each output channel
    c.op(2 * masks * mp * mp * cin_m * dred * 4, train, train)
    mo = 2 * mp
    c.op(2 * masks * mo * mo * dred * (1 if train else classes), train, train)
    return c.fwd, c.bwd


def _res5(c, rois, r, p, train):
    out2 = r["RES2_OUT_CHANNELS"]
    width = r["NUM_GROUPS"] * r["WIDTH_PER_GROUP"] * 8
    h, _ = _res_stage(c, rois, out2 * 4, width, out2 * 8, 3, p, p, 2, train, train)
    return h
