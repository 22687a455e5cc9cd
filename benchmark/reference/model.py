"""The reference Mask R-CNN: R-50-FPN and R-50-C4, training and inference.

A frozen copy of the program's plain model (maskrcnn_tpu_torch/models:
layers, resnet, fpn, backbone, anchors, rpn, roi_heads/box_head,
roi_heads/mask_head, detector) for the configurations the benchmark runs:
frozen BN folded into the convs, the FPN without group norm, the single
conv RPN head, the MLP and res5 box heads, the FPN and shared-res5 mask
heads. Module and parameter names are the program's, so one state dict
loads into both. It computes in float32; ``set_precision(model, "fp8")``
rounds what a bf16 model stores in bf16 to float8 e4m3 instead (a
per-tensor scale each, the products in float32), and their gradients to
float8 e5m2, the control that a lower precision must fail. It imports nothing of the program.

The harness reaches it by name (configs/<config>.json "reference": "model")
through harness/spec.py's REFERENCE_API: MaskRCNN, set_precision,
training_proposals and calibrate.
"""

from collections import namedtuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import ops

def _round(x, dtype, top):
    scale = x.abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class FakeFP8(torch.autograd.Function):
    """Forward: x rounded to float8 e4m3 under a per-tensor scale (its amax
    to 448). Backward: the gradient rounded to float8 e5m2 likewise (amax to
    57344): the hybrid format of fp8 training."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, 57344.0)


def _int8(x):
    scale = x.abs().amax().clamp(min=1e-30) / 127.0
    return torch.round(x / scale).clamp(-127, 127) * scale


class FakeInt8(torch.autograd.Function):
    """x, and its gradient, rounded to int8 under a per-tensor symmetric
    scale (amax to 127)."""

    @staticmethod
    def forward(ctx, x):
        return _int8(x)

    @staticmethod
    def backward(ctx, grad):
        return _int8(grad)


class FakeBF16(torch.autograd.Function):
    """x, and its gradient, rounded to bfloat16 (a diagnostic beside the
    control)."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(torch.bfloat16).to(grad.dtype)


class _Rounded:
    precision = None

    def _q(self, t):
        if self.precision is None:
            return t
        return {"fp8": FakeFP8, "int8": FakeInt8, "bf16": FakeBF16}[self.precision].apply(t)


class Conv2d(_Rounded, nn.Conv2d):
    def forward(self, x, weight=None, bias=None):
        w = self.weight if weight is None else weight
        b = self.bias if bias is None else bias
        return self._q(F.conv2d(self._q(x), self._q(w), b, self.stride, self.padding,
                                self.dilation, self.groups))


class ConvTranspose2d(_Rounded, nn.ConvTranspose2d):
    def forward(self, x):
        return self._q(F.conv_transpose2d(self._q(x), self._q(self.weight), self.bias,
                                          self.stride, self.padding))


class Linear(_Rounded, nn.Linear):
    def forward(self, x):
        return self._q(F.linear(self._q(x), self._q(self.weight), self.bias))


def set_precision(model, precision):
    """None (float32) or "fp8": every conv's and fc's input, weight and
    output, each block's and FPN sum's output, the stem's and the poolers'
    outputs rounded to float8 e4m3, as a bf16 model stores them in bf16."""
    for m in model.modules():
        if isinstance(m, _Rounded):
            m.precision = precision


class FrozenBatchNorm2d(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.register_buffer("weight", torch.ones(c))
        self.register_buffer("bias", torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def scale_shift(self):
        s = self.weight * torch.rsqrt(self.running_var)
        return s, self.bias - self.running_mean * s


def conv_frozen_bn(x, conv, bn):
    """conv then frozen BN, the BN's affine folded into the conv."""
    s, t = bn.scale_shift()
    return conv(x, weight=conv.weight * s[:, None, None, None], bias=t)


# -- ResNet ----------------------------------------------------------------------------

StageSpec = namedtuple("StageSpec", ["index", "block_count", "return_features"])
STAGE_SPECS = {
    "R-50-C4": [StageSpec(1, 3, False), StageSpec(2, 4, False), StageSpec(3, 6, True)],
    "R-50-FPN": [StageSpec(1, 3, True), StageSpec(2, 4, True), StageSpec(3, 6, True),
                 StageSpec(4, 3, True)],
}


class Bottleneck(_Rounded, nn.Module):
    def __init__(self, cin, bottleneck, cout, stride, stride_in_1x1):
        super().__init__()
        s1, s2 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = Conv2d(cin, bottleneck, 1, stride=s1, bias=False)
        self.bn1 = FrozenBatchNorm2d(bottleneck)
        self.conv2 = Conv2d(bottleneck, bottleneck, 3, stride=s2, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(bottleneck)
        self.conv3 = Conv2d(bottleneck, cout, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(cout)
        self.downsample = None
        if cin != cout:
            self.downsample = nn.Module()
            self.downsample.conv = Conv2d(cin, cout, 1, stride=stride, bias=False)
            self.downsample.bn = FrozenBatchNorm2d(cout)

    def forward(self, x, norm=conv_frozen_bn):
        out = F.relu(norm(x, self.conv1, self.bn1))
        out = F.relu(norm(out, self.conv2, self.bn2))
        out = norm(out, self.conv3, self.bn3)
        identity = x if self.downsample is None else norm(x, self.downsample.conv,
                                                            self.downsample.bn)
        return self._q(F.relu(out + identity))


def _stage(cin, bottleneck, cout, count, first_stride, stride_in_1x1):
    return nn.ModuleList([Bottleneck(cin if k == 0 else cout, bottleneck, cout,
                                     first_stride if k == 0 else 1, stride_in_1x1)
                          for k in range(count)])


class ResNet(_Rounded, nn.Module):
    def __init__(self, cfg):
        super().__init__()
        r = cfg["MODEL"]["RESNETS"]
        specs = STAGE_SPECS[cfg["MODEL"]["BACKBONE"]["CONV_BODY"]]
        width = r["NUM_GROUPS"] * r["WIDTH_PER_GROUP"]
        out2 = r["RES2_OUT_CHANNELS"]
        self.stem = nn.Module()
        self.stem.conv1 = Conv2d(3, r["STEM_OUT_CHANNELS"], 7, stride=2, padding=3, bias=False)
        self.stem.bn1 = FrozenBatchNorm2d(r["STEM_OUT_CHANNELS"])
        self.stage_names, self.return_features = [], []
        for spec in specs:
            i = spec.index
            cin = r["STEM_OUT_CHANNELS"] if i == 1 else out2 * 2 ** (i - 2)
            name = "layer{}".format(i)
            setattr(self, name, _stage(cin, width * 2 ** (i - 1), out2 * 2 ** (i - 1),
                                       spec.block_count, 1 if i == 1 else 2,
                                       r["STRIDE_IN_1X1"]))
            self.stage_names.append(name)
            self.return_features.append(spec.return_features)
        freeze_at = cfg["MODEL"]["BACKBONE"]["FREEZE_CONV_BODY_AT"]
        frozen = ([self.stem] if freeze_at >= 1 else []) + [
            getattr(self, n) for k, n in enumerate(self.stage_names) if freeze_at >= k + 2]
        for module in frozen:
            module.requires_grad_(False)

    def forward(self, x, norm=conv_frozen_bn):
        x = self._q(F.max_pool2d(F.relu(norm(x, self.stem.conv1, self.stem.bn1)), 3, 2, 1))
        outputs = []
        for name, ret in zip(self.stage_names, self.return_features):
            for block in getattr(self, name):
                x = block(x, norm)
            if ret:
                outputs.append(x)
        return outputs


class ResNetHead(nn.Module):
    """The C4 heads' res5: three bottlenecks, the first at stride 2."""

    def __init__(self, cfg):
        super().__init__()
        r = cfg["MODEL"]["RESNETS"]
        out2 = r["RES2_OUT_CHANNELS"]
        self.out_channels = out2 * 8
        self.layer4 = _stage(out2 * 4, r["NUM_GROUPS"] * r["WIDTH_PER_GROUP"] * 8, out2 * 8, 3,
                             2, r["STRIDE_IN_1X1"])

    def forward(self, x):
        for block in self.layer4:
            x = block(x)
        return x


class _ConvBlock(nn.Module):
    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, padding=k // 2)

    def forward(self, x):
        return self.conv(x)


class FPN(_Rounded, nn.Module):
    def __init__(self, in_channels_list, out_channels):
        super().__init__()
        self.inner = nn.ModuleList([_ConvBlock(c, out_channels, 1) for c in in_channels_list])
        self.layer = nn.ModuleList([_ConvBlock(out_channels, out_channels, 3)
                                    for _ in in_channels_list])

    def forward(self, features):
        last_inner = self.inner[-1](features[-1])
        results = [self.layer[-1](last_inner)]
        for feature, inner, layer in zip(features[-2::-1], self.inner[-2::-1],
                                         self.layer[-2::-1]):
            last_inner = self._q(inner(feature) + F.interpolate(last_inner, scale_factor=2,
                                                                mode="nearest"))
            results.insert(0, layer(last_inner))
        results.append(results[-1][:, :, ::2, ::2])
        return results


class Backbone(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.body = ResNet(cfg)
        self.out_channels = cfg["MODEL"]["RESNETS"]["BACKBONE_OUT_CHANNELS"]
        self.fpn = None
        if "FPN" in cfg["MODEL"]["BACKBONE"]["CONV_BODY"]:
            out2 = cfg["MODEL"]["RESNETS"]["RES2_OUT_CHANNELS"]
            self.fpn = FPN([out2, out2 * 2, out2 * 4, out2 * 8], self.out_channels)

    def forward(self, x):
        features = self.body(x)
        return self.fpn(features) if self.fpn is not None else features


# -- anchors -------------------------------------------------------------------------------


def _whctrs(anchor):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    return w, h, anchor[0] + 0.5 * (w - 1), anchor[1] + 0.5 * (h - 1)


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack((x_ctr - 0.5 * (ws - 1), y_ctr - 0.5 * (hs - 1),
                      x_ctr + 0.5 * (ws - 1), y_ctr + 0.5 * (hs - 1)))


def cell_anchors(stride, sizes, aspect_ratios):
    """Detectron's cell anchors, [A, 4] float32."""
    scales = np.array(sizes, np.float64) / stride
    ratios = np.array(aspect_ratios, np.float64)
    base = np.array([1, 1, stride, stride], np.float64) - 1
    w, h, xc, yc = _whctrs(base)
    ws = np.round(np.sqrt(w * h / ratios))
    anchors = _mkanchors(ws, np.round(ws * ratios), xc, yc)
    out = []
    for a in anchors:
        w, h, xc, yc = _whctrs(a)
        out.append(_mkanchors(w * scales, h * scales, xc, yc))
    return np.vstack(out).astype(np.float32)


class Anchors:
    def __init__(self, cfg):
        r = cfg["MODEL"]["RPN"]
        strides = list(r["ANCHOR_STRIDE"])
        if len(strides) == 1:
            self.cells = [cell_anchors(strides[0], r["ANCHOR_SIZES"], r["ASPECT_RATIOS"])]
        else:
            self.cells = [cell_anchors(s, (size,), r["ASPECT_RATIOS"])
                          for s, size in zip(strides, r["ANCHOR_SIZES"])]
        self.strides = strides
        self.straddle = r["STRADDLE_THRESH"]

    def num_per_location(self):
        return len(self.cells[0])

    def grid(self, level, gh, gw, device):
        cell = torch.as_tensor(self.cells[level], device=device)
        stride = self.strides[level]
        sy, sx = torch.meshgrid(torch.arange(gh, dtype=torch.float32, device=device) * stride,
                                torch.arange(gw, dtype=torch.float32, device=device) * stride,
                                indexing="ij")
        shifts = torch.stack([sx.reshape(-1), sy.reshape(-1), sx.reshape(-1), sy.reshape(-1)], 1)
        return (shifts[:, None, :] + cell[None]).reshape(-1, 4)

    def visibility(self, anchors, h, w):
        t = self.straddle
        return ((anchors[..., 0] >= -t) & (anchors[..., 1] >= -t)
                & (anchors[..., 2] < w + t) & (anchors[..., 3] < h + t))


# -- RPN -------------------------------------------------------------------------------------


class RPNHead(nn.Module):
    def __init__(self, c, a):
        super().__init__()
        self.conv = Conv2d(c, c, 3, padding=1)
        self.cls_logits = Conv2d(c, a, 1)
        self.bbox_pred = Conv2d(c, a * 4, 1)

    def forward(self, features):
        objectness, bbox_reg = [], []
        for f in features:
            t = F.relu(self.conv(f))
            objectness.append(self.cls_logits(t))
            bbox_reg.append(self.bbox_pred(t))
        return objectness, bbox_reg


def _pad_to(x, k, fill):
    pad = k - x.shape[1]
    if pad == 0:
        return x
    shape = (x.shape[0], pad) + tuple(x.shape[2:])
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim=1)


def select_proposals(anchors_per_level, objectness, bbox_reg, image_sizes, r, train,
                     gt_boxes=None, gt_valid=None):
    """Per-level top-k, decode, clip, NMS per (level, image), per-lane
    top-k, the FPN top-k (over the whole batch in training), gt appended."""
    phase = "TRAIN" if train else "TEST"
    pre_nms, post_nms = r["PRE_NMS_TOP_N_" + phase], r["POST_NMS_TOP_N_" + phase]
    fpn_post = r["FPN_POST_NMS_TOP_N_" + phase]
    h = image_sizes[:, 0:1].float()
    w = image_sizes[:, 1:2].float()
    levels = len(anchors_per_level)
    cand = []
    for anchors, obj, reg in zip(anchors_per_level, objectness, bbox_reg):
        b, a = obj.shape[0], obj.shape[1]
        obj = obj.permute(0, 2, 3, 1).reshape(b, -1)
        reg = reg.permute(0, 2, 3, 1).reshape(b, -1, a, 4).reshape(b, -1, 4)
        k = min(pre_nms, obj.shape[1])
        top_scores, top_idx = ops.top_k_fast(torch.sigmoid(obj.float()), k)
        deltas = torch.gather(reg.float(), 1, top_idx[..., None].expand(-1, -1, 4))
        boxes = ops.clip_boxes_to_image(ops.decode_boxes(deltas, anchors[top_idx]), (h, w))
        cand.append((boxes, top_scores, ops.small_box_mask(boxes, r["MIN_SIZE"])))
    b = cand[0][1].shape[0]
    k_max = max(c[1].shape[1] for c in cand)
    sb = torch.cat([_pad_to(c[0], k_max, 0.0) for c in cand])
    ss = torch.cat([_pad_to(c[1], k_max, ops.NEG_INF) for c in cand])
    sv = torch.cat([_pad_to(c[2], k_max, False) for c in cand])
    keep = ops.batched_nms(sb, ss, sv, r["NMS_THRESH"])
    masked = torch.where(keep, ss, torch.full_like(ss, ops.NEG_INF))
    k_post = min(post_nms, k_max)
    sel_scores, sel = ops.top_k_stable(masked, k_post)
    sel_valid = sel_scores > ops.NEG_INF / 2
    sel_boxes = torch.gather(sb, 1, sel[..., None].expand(-1, -1, 4))
    sel_boxes = torch.where(sel_valid[..., None], sel_boxes, torch.zeros_like(sel_boxes))
    sel_scores = torch.where(sel_valid, sel_scores, torch.zeros_like(sel_scores))
    boxes = sel_boxes.reshape(levels, b, k_post, 4).transpose(0, 1).reshape(b, -1, 4)
    scores = sel_scores.reshape(levels, b, k_post).transpose(0, 1).reshape(b, -1)
    valid = sel_valid.reshape(levels, b, k_post).transpose(0, 1).reshape(b, -1)
    if levels > 1:
        k = min(fpn_post, scores.shape[1])
        masked = torch.where(valid, scores, torch.full_like(scores, ops.NEG_INF))
        if train and r["FPN_POST_NMS_PER_BATCH"]:
            flat = masked.reshape(-1)
            kth = torch.topk(flat, min(fpn_post, flat.numel())).values[-1]
            keep = masked >= torch.clamp(kth, min=ops.NEG_INF / 2)
            masked = torch.where(keep, masked, torch.full_like(masked, ops.NEG_INF))
        sel_scores, sel = ops.top_k_fast(masked, k)
        valid = sel_scores > ops.NEG_INF / 2
        boxes = torch.gather(boxes, 1, sel[..., None].expand(-1, -1, 4))
        boxes = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
        scores = torch.where(valid, sel_scores, torch.zeros_like(sel_scores))
    if train:
        boxes = torch.cat([boxes, gt_boxes.to(boxes.dtype)], dim=1)
        scores = torch.cat([scores, gt_valid.to(scores.dtype)], dim=1)
        valid = torch.cat([valid, gt_valid], dim=1)
    return boxes, scores, valid


def rpn_loss(anchors, visible, objectness, bbox_reg, gt_boxes, gt_valid, pos_draw, neg_draw, r):
    matched = ops.match_anchors(anchors, gt_boxes, gt_valid, r["FG_IOU_THRESHOLD"],
                                r["BG_IOU_THRESHOLD"])
    labels = torch.where(matched >= 0, 1, torch.where(matched == -1, 0, -1))
    labels = torch.where(visible, labels, -1)
    idx, valid, is_pos = ops.sample_topk_indices(labels, pos_draw, neg_draw,
                                                 r["BATCH_SIZE_PER_IMAGE"], r["POSITIVE_FRACTION"])
    m_idx = torch.gather(matched, 1, idx).clamp(min=0).long()
    gt_sel = torch.gather(gt_boxes, 1, m_idx[..., None].expand(-1, -1, 4))
    reg_t = ops.encode_boxes(gt_sel, anchors[idx])
    obj_s = torch.gather(objectness, 1, idx)
    reg_s = torch.gather(bbox_reg, 1, idx[..., None].expand(-1, -1, 4))
    n_sampled = valid.sum().clamp(min=1)
    box_l = ops.smooth_l1_loss(reg_s.float(), reg_t, beta=1.0 / 9)
    obj_l = ops.binary_cross_entropy_with_logits(obj_s.float(), is_pos.float())
    return (obj_l * valid).sum() / n_sampled, (box_l * is_pos[..., None]).sum() / n_sampled


# -- ROI heads --------------------------------------------------------------------------------


class BoxHead(nn.Module):
    def __init__(self, cfg, c):
        super().__init__()
        h = cfg["MODEL"]["ROI_BOX_HEAD"]
        self.feature_extractor = nn.Module()
        if h["FEATURE_EXTRACTOR"] == "FPN2MLPFeatureExtractor":
            res, dim = h["POOLER_RESOLUTION"], h["MLP_HEAD_DIM"]
            self.feature_extractor.fc6 = Linear(c * res * res, dim)
            self.feature_extractor.fc7 = Linear(dim, dim)
            self.res5 = False
            out = dim
        elif h["FEATURE_EXTRACTOR"] == "ResNet50Conv5ROIFeatureExtractor":
            self.feature_extractor.head = ResNetHead(cfg)
            self.res5 = True
            out = self.feature_extractor.head.out_channels
        else:
            raise NotImplementedError(h["FEATURE_EXTRACTOR"])
        self.out_dim = out
        self.predictor = nn.Module()
        self.predictor.cls_score = Linear(out, h["NUM_CLASSES"])
        self.predictor.bbox_pred = Linear(out, h["NUM_CLASSES"] * 4)

    def extract(self, pooled):
        """[R, P, P, C] -> [R, D] (MLP) or NCHW [R, 2048, P/2, P/2] (res5)."""
        fe = self.feature_extractor
        if self.res5:
            return fe.head(pooled.permute(0, 3, 1, 2))
        x = F.relu(fe.fc6(pooled.reshape(pooled.shape[0], -1)))
        return F.relu(fe.fc7(x))

    def predict(self, x):
        if x.ndim == 4:
            x = x.mean(dim=(2, 3))
        return self.predictor.cls_score(x).float(), self.predictor.bbox_pred(x).float()


def _take(x, idx):
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def prepare_box_targets(proposals, prop_valid, gt_boxes, gt_labels, pos_draw, neg_draw, h):
    iou = ops.box_iou(gt_boxes, proposals)
    iou = torch.where(prop_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    matched = ops.match_proposals(iou, gt_labels > 0, h["FG_IOU_THRESHOLD"],
                                  h["BG_IOU_THRESHOLD"])
    safe = matched.clamp(min=0).long()
    cls_labels = torch.where(matched >= 0, torch.gather(gt_labels, 1, safe).long(),
                             torch.where(matched == -1, 0, -1))
    cls_labels = torch.where(prop_valid, cls_labels, -1)
    idx, valid, is_pos = ops.sample_topk_indices(cls_labels, pos_draw, neg_draw,
                                                 h["BATCH_SIZE_PER_IMAGE"], h["POSITIVE_FRACTION"])
    rois = _take(proposals, idx)
    labels = torch.where(valid, torch.gather(cls_labels, 1, idx).clamp(min=0), -1)
    mg = torch.gather(safe, 1, idx)
    reg_targets = ops.encode_boxes(_take(gt_boxes, mg), rois, tuple(h["BBOX_REG_WEIGHTS"]))
    return dict(rois=rois, labels=labels, reg_targets=reg_targets, valid=valid, is_pos=is_pos,
                matched_gt_idx=mg)


def box_head_loss(class_logits, box_regression, targets):
    labels = targets["labels"].reshape(-1)
    valid = targets["valid"].reshape(-1)
    is_pos = targets["is_pos"].reshape(-1) & valid
    reg_targets = targets["reg_targets"].reshape(-1, 4)
    cls_loss = ops.softmax_cross_entropy(class_logits, labels, valid)
    num_reg = box_regression.shape[-1] // 4
    cols = labels.clamp(0, num_reg - 1)[:, None] * 4 + torch.arange(4, device=labels.device)[None]
    picked = torch.gather(box_regression, 1, cols)
    l1 = ops.smooth_l1_loss(picked, reg_targets, beta=1.0)
    return cls_loss, (l1 * is_pos[:, None]).sum() / valid.sum().clamp(min=1)


def box_head_inference(class_logits, box_regression, proposals, prop_valid, image_sizes, h,
                       detections_per_img):
    b, n, c = class_logits.shape
    probs = torch.softmax(class_logits, dim=-1)
    decoded = ops.decode_boxes(box_regression, proposals,
                               tuple(h["BBOX_REG_WEIGHTS"])).reshape(b, n, c, 4)
    hh = image_sizes[:, 0:1].float()
    ww = image_sizes[:, 1:2].float()
    decoded = ops.clip_boxes_to_image(decoded.reshape(b, n * c, 4), (hh, ww)).reshape(b, n, c, 4)
    nc = c - 1
    cls_boxes = decoded[:, :, 1:, :].permute(0, 2, 1, 3).reshape(b * nc, n, 4)
    cls_scores = probs[:, :, 1:].permute(0, 2, 1).reshape(b * nc, n)
    cls_valid = (cls_scores > h["SCORE_THRESH"]) & prop_valid.repeat_interleave(nc, dim=0)
    k_nms = min(n, max(detections_per_img * 2, 128))
    masked = torch.where(cls_valid, cls_scores, torch.full_like(cls_scores, ops.NEG_INF))
    top_sc, top_ix = ops.top_k_stable(masked, k_nms)
    top_bx = torch.gather(cls_boxes, 1, top_ix[..., None].expand(-1, -1, 4))
    keep = ops.batched_nms(top_bx, top_sc, top_sc > ops.NEG_INF / 2, h["NMS"])
    kept = torch.where(keep, top_sc, torch.full_like(top_sc, ops.NEG_INF)).reshape(b, nc * k_nms)
    out_scores, flat_idx = ops.top_k_stable(kept, detections_per_img)
    out_valid = out_scores > ops.NEG_INF / 2
    out_boxes = torch.gather(top_bx.reshape(b, nc * k_nms, 4), 1,
                             flat_idx[..., None].expand(-1, -1, 4))
    out_boxes = torch.where(out_valid[..., None], out_boxes, torch.zeros_like(out_boxes))
    out_labels = torch.where(out_valid, flat_idx // k_nms + 1,
                             torch.zeros_like(flat_idx)).to(torch.int32)
    out_scores = torch.where(out_valid, out_scores, torch.zeros_like(out_scores))
    return dict(boxes=out_boxes, scores=out_scores, labels=out_labels, valid=out_valid)


class MaskHead(nn.Module):
    """The FPN mask head (4 convs, deconv, 1x1) or, when it shares the box
    head's res5 extractor, the deconv and the 1x1 conv alone."""

    def __init__(self, cfg, c, shared_dim=None):
        super().__init__()
        h = cfg["MODEL"]["ROI_MASK_HEAD"]
        self.feature_extractor = None
        if shared_dim is None:
            self.feature_extractor = nn.Module()
            self.feature_extractor.convs = nn.ModuleList()
            cin = c
            for cout in h["CONV_LAYERS"]:
                blk = nn.Module()
                blk.conv = Conv2d(cin, cout, 3, padding=h["DILATION"], dilation=h["DILATION"])
                self.feature_extractor.convs.append(blk)
                cin = cout
            shared_dim = cin
        self.predictor = nn.Module()
        self.predictor.conv5_mask = ConvTranspose2d(shared_dim, h["CONV_LAYERS"][-1], 2, stride=2)
        self.predictor.mask_fcn_logits = Conv2d(h["CONV_LAYERS"][-1],
                                                cfg["MODEL"]["ROI_BOX_HEAD"]["NUM_CLASSES"], 1)

    def _upsampled(self, x):
        if self.feature_extractor is not None:
            x = x.permute(0, 3, 1, 2)
            for blk in self.feature_extractor.convs:
                x = F.relu(blk.conv(x))
        return F.relu(self.predictor.conv5_mask(x))

    def forward(self, x, labels):
        logits = self.predictor.mask_fcn_logits(self._upsampled(x)).float()
        safe = labels.long().clamp(0, logits.shape[1] - 1)
        return torch.sigmoid(logits[torch.arange(logits.shape[0], device=logits.device), safe])

    def logits_at_class(self, x, labels):
        x = self._upsampled(x)
        fcn = self.predictor.mask_fcn_logits
        safe = labels.long().clamp(0, fcn.out_channels - 1)
        wl = fcn._q(fcn.weight)[:, :, 0, 0][safe]
        return (torch.einsum("rdhw,rd->rhw", x, wl) + fcn.bias[safe][:, None, None]).float()


def select_positive_rois(targets, k_mask):
    is_pos = targets["is_pos"] & targets["valid"]
    k = is_pos.shape[1]
    score = is_pos.float() - torch.arange(k, device=is_pos.device)[None, :] * 1e-6
    top, idx = ops.top_k_stable(score, min(k_mask, k))
    return idx, top > 0.5


def project_gt_masks(gt_patches, gt_boxes, proposal_boxes, m):
    r, s, _ = gt_patches.shape
    gx1, gy1, gx2, gy2 = gt_boxes.unbind(-1)
    px1, py1, px2, py2 = proposal_boxes.unbind(-1)
    gw = (gx2 - gx1).clamp(min=1.0)
    gh = (gy2 - gy1).clamp(min=1.0)
    pw = (px2 - px1).clamp(min=1.0)
    ph = (py2 - py1).clamp(min=1.0)
    u = (torch.arange(m, dtype=torch.float32, device=gt_boxes.device) + 0.5) / m
    size = torch.full_like(gw, float(s))
    xq = (px1[:, None] + u[None, :] * pw[:, None] - gx1[:, None]) * (size / gw)[:, None] - 0.5
    yq = (py1[:, None] + u[None, :] * ph[:, None] - gy1[:, None]) * (size / gh)[:, None] - 0.5
    patches = gt_patches.float()
    y0 = torch.floor(yq).long()
    x0 = torch.floor(xq).long()
    wy = (yq - y0)[:, :, None]
    wx = (xq - x0)[:, None, :]
    rows = torch.arange(r, device=patches.device)[:, None, None]

    def corner(yi, xi):
        inside = (((yi >= 0) & (yi <= s - 1))[:, :, None] & ((xi >= 0) & (xi <= s - 1))[:, None, :])
        return patches[rows, yi.clamp(0, s - 1)[:, :, None], xi.clamp(0, s - 1)[:, None, :]] * inside

    return (corner(y0, x0) * (1 - wy) * (1 - wx) + corner(y0, x0 + 1) * (1 - wy) * wx
            + corner(y0 + 1, x0) * wy * (1 - wx) + corner(y0 + 1, x0 + 1) * wy * wx)


def mask_loss(picked, targets, valid):
    m = picked.shape[1]
    t = (targets >= 0.5).float()
    w = valid.float()[:, None, None]
    return ((F.softplus(picked) - picked * t) * w).sum() / (w.sum() * m * m).clamp(min=1.0)


# -- the detector -------------------------------------------------------------------------------


def _flatten_rois(boxes):
    b, k, _ = boxes.shape
    return boxes.reshape(b * k, 4), torch.arange(b, device=boxes.device).repeat_interleave(k)


def _level_major(per_level, b, last):
    return torch.cat([t.permute(0, 2, 3, 1).reshape(b, -1, last) for t in per_level], dim=1)


class MaskRCNN(_Rounded, nn.Module):
    """cfg: the configuration as nested dicts (the port's defaults merged
    with the configuration file). Float32 throughout."""

    def __init__(self, cfg):
        super().__init__()
        m = cfg["MODEL"]
        self.cfg = cfg
        self.register_buffer("pixel_mean", torch.tensor(cfg["INPUT"]["PIXEL_MEAN"]),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg["INPUT"]["PIXEL_STD"]),
                             persistent=False)
        self.backbone = Backbone(cfg)
        c = self.backbone.out_channels
        self.anchors = Anchors(cfg)
        self.rpn = RPNHead(c, self.anchors.num_per_location())
        self.roi_heads = nn.Module()
        self.roi_heads.box = BoxHead(cfg, c)
        b, mk = m["ROI_BOX_HEAD"], m["ROI_MASK_HEAD"]
        self.box_pooler = ops.PoolerConfig(b["POOLER_RESOLUTION"], b["POOLER_SCALES"],
                                           b["POOLER_SAMPLING_RATIO"])
        self.share = mk["SHARE_BOX_FEATURE_EXTRACTOR"]
        self.roi_heads.mask = MaskHead(cfg, c, self.roi_heads.box.out_dim if self.share else None)
        self.mask_pooler = ops.PoolerConfig(mk["POOLER_RESOLUTION"], mk["POOLER_SCALES"],
                                            mk["POOLER_SAMPLING_RATIO"])
        self.num_pos = int(m["ROI_HEADS"]["BATCH_SIZE_PER_IMAGE"]
                           * m["ROI_HEADS"]["POSITIVE_FRACTION"])

    def normalize(self, images, image_sizes):
        """uint8 RGB [B, H, W, 3] -> BGR255 less the pixel mean, padding 0;
        float batches are taken as normalized."""
        if images.dtype != torch.uint8:
            return images
        x = (images.float().flip(-1) - self.pixel_mean) / self.pixel_std
        _, h, w, _ = x.shape
        ys = torch.arange(h, device=x.device)[None, :, None, None]
        xs = torch.arange(w, device=x.device)[None, None, :, None]
        inside = ((ys < image_sizes[:, 0][:, None, None, None])
                  & (xs < image_sizes[:, 1][:, None, None, None]))
        return torch.where(inside, x, torch.zeros((), device=x.device))

    def features(self, batch):
        x = self.normalize(batch["images"], batch["image_sizes"]).permute(0, 3, 1, 2)
        features = self.backbone(x.contiguous())
        anchors = [self.anchors.grid(l, f.shape[2], f.shape[3], f.device)
                   for l, f in enumerate(features)]
        return features, anchors

    def pool(self, nhwc, rois, bidx, pcfg, rois_per_image=None):
        return self._q(ops.roi_align(nhwc[:len(pcfg.scales)], rois, bidx, pcfg, rois_per_image))

    def _mask_input(self, nhwc, rois, bidx, rois_per_image=None):
        if self.share:
            return self.roi_heads.box.extract(self.pool(nhwc, rois, bidx, self.box_pooler,
                                                        rois_per_image))
        return self.pool(nhwc, rois, bidx, self.mask_pooler, rois_per_image)

    def train_forward(self, batch, draws, mask_roi_cap, proposals_at=None, record=None):
        """The five losses of one step. draws: rpn_pos, rpn_neg [B, N
        anchors], box_pos, box_neg [B, P proposals]; mask_roi_cap: the
        positives kept an image, batch-wide (TPU.MASK_ROI_CAP).
        proposals_at: (boxes [B', P, 4], valid [B', P]), the proposals (gt
        appended) that the ROI heads take for the first B' images in place
        of this model's own; record: a dict that gets this step's "rpn"
        (objectness, bbox_reg per level) and "proposals" (boxes, scores,
        valid) as the ROI heads take them."""
        m = self.cfg["MODEL"]
        gt_boxes = batch["gt_boxes"].float()
        gt_labels = batch["gt_labels"]
        gt_valid = gt_labels > 0
        sizes = batch["image_sizes"]
        b = gt_boxes.shape[0]
        features, anchors = self.features(batch)
        objectness, bbox_reg = self.rpn(features)
        cat_anchors = torch.cat(anchors)
        visible = self.anchors.visibility(cat_anchors, sizes[:, 0:1].float(), sizes[:, 1:2].float())
        loss_obj, loss_rpn_box = rpn_loss(
            cat_anchors, visible, _level_major(objectness, b, 1)[..., 0],
            _level_major(bbox_reg, b, 4), gt_boxes, gt_valid, draws["rpn_pos"], draws["rpn_neg"],
            m["RPN"])
        losses = {"loss_objectness": loss_obj, "loss_rpn_box_reg": loss_rpn_box}
        with torch.no_grad():
            rpn = ([o.detach() for o in objectness], [r.detach() for r in bbox_reg])
            forced = 0 if proposals_at is None else proposals_at[0].shape[0]
            props = prop_scores = prop_valid = None
            if forced < b:
                props, prop_scores, prop_valid = select_proposals(
                    anchors, *rpn, sizes, m["RPN"], True, gt_boxes, gt_valid)
            if forced:
                boxes, valid = (t.to(gt_boxes.device) for t in proposals_at)
                props = boxes.float() if props is None else torch.cat([boxes.float(),
                                                                       props[forced:]])
                prop_valid = valid if prop_valid is None else torch.cat([valid,
                                                                         prop_valid[forced:]])
                prop_scores = None
            if record is not None:
                record["rpn"] = rpn
                record["proposals"] = (props, prop_scores, prop_valid)
            targets = prepare_box_targets(props, prop_valid, gt_boxes, gt_labels,
                                          draws["box_pos"], draws["box_neg"], m["ROI_HEADS"])
        rois, bidx = _flatten_rois(targets["rois"])
        nhwc = [f.permute(0, 2, 3, 1).contiguous() for f in features]
        pooled = self.pool(nhwc, rois, bidx, self.box_pooler, targets["rois"].shape[1])
        class_logits, box_regression = self.roi_heads.box.predict(self.roi_heads.box.extract(pooled))
        losses["loss_classifier"], losses["loss_box_reg"] = box_head_loss(
            class_logits, box_regression, targets)
        with torch.no_grad():
            pos_idx, pos_valid = select_positive_rois(targets, self.num_pos)
            rows = torch.arange(b, device=pos_idx.device)[:, None]
            p_rois, p_bidx = _flatten_rois(targets["rois"][rows, pos_idx])
            state = (p_rois, p_bidx, pos_valid.reshape(-1),
                     targets["labels"][rows, pos_idx].reshape(-1),
                     targets["matched_gt_idx"][rows, pos_idx].reshape(-1))
            cap = mask_roi_cap * b
            if 0 < cap < state[2].shape[0]:
                sel = torch.sort(ops.top_k_stable(state[2].float(), cap)[1]).values
                state = tuple(x[sel] for x in state)
        m_rois, m_bidx, m_valid, m_labels, m_mg = state
        logits = self.roi_heads.mask.logits_at_class(self._mask_input(nhwc, m_rois, m_bidx),
                                                     m_labels)
        with torch.no_grad():
            gt_masks = batch["gt_masks"]
            g, s = gt_masks.shape[1], gt_masks.shape[-1]
            flat = m_bidx.long() * g + m_mg
            tgt = project_gt_masks(gt_masks.reshape(-1, s, s)[flat], gt_boxes.reshape(-1, 4)[flat],
                                   m_rois, logits.shape[1])
        losses["loss_mask"] = mask_loss(logits, tgt, m_valid)
        return losses

    def _box_head_at(self, nhwc, boxes):
        """Class logits [B, N, C] and box regression [B, N, 4C] at boxes [B,
        N, 4]."""
        b, n = boxes.shape[:2]
        rois, bidx = _flatten_rois(boxes)
        pooled = self.pool(nhwc, rois, bidx, self.box_pooler, n)
        logits, reg = self.roi_heads.box.predict(self.roi_heads.box.extract(pooled))
        return logits.reshape(b, n, -1), reg.reshape(b, n, -1)

    def _masks_at(self, nhwc, boxes, labels):
        """Mask probabilities [B, D, M, M] at boxes [B, D, 4] of classes
        labels [B, D]."""
        b, d = boxes.shape[:2]
        rois, bidx = _flatten_rois(boxes)
        probs = self.roi_heads.mask(self._mask_input(nhwc, rois, bidx, d), labels.reshape(-1))
        return probs.reshape(b, d, probs.shape[-2], probs.shape[-1])

    @torch.no_grad()
    def infer_forward(self, batch, record=None):
        """The padded detections: boxes, scores, labels, valid [B, D] and
        the mask probabilities [B, D, M, M] of each detection's class. record:
        a dict that gets the stages as program.capture records the
        program's: "rpn", "proposals", "box_head" (class logits, box
        regression) and "detections" (before the masks)."""
        m = self.cfg["MODEL"]
        sizes = batch["image_sizes"]
        features, anchors = self.features(batch)
        objectness, bbox_reg = self.rpn(features)
        props, scores, prop_valid = select_proposals(anchors, objectness, bbox_reg, sizes,
                                                     m["RPN"], False)
        nhwc = [f.permute(0, 2, 3, 1).contiguous() for f in features]
        logits, reg = self._box_head_at(nhwc, props)
        det = box_head_inference(logits, reg, props, prop_valid, sizes, m["ROI_HEADS"],
                                 m["ROI_HEADS"]["DETECTIONS_PER_IMG"])
        if record is not None:
            record.update(rpn=(objectness, bbox_reg), proposals=(props, scores, prop_valid),
                          box_head=(logits, reg), detections=dict(det))
        det["masks"] = self._masks_at(nhwc, det["boxes"], det["labels"])
        return det

    @torch.no_grad()
    def judge(self, batch, side):
        """This model's counterpart of each stage of a batch's inference on
        the side judged, each from that stage's own input on that side:
        {"rpn": this model's RPN head outputs; "proposals": the proposal
        stage over the side's RPN head outputs; "box_head": this model's box
        head at the side's proposals; "detections": the box post-process of
        the side's box head outputs and proposals; "masks": this model's
        mask probabilities at the side's detections' boxes and labels}.
        side: the stages as infer_forward records them, with "masks"."""
        m = self.cfg["MODEL"]
        sizes = batch["image_sizes"]
        dev = sizes.device
        features, anchors = self.features(batch)
        rpn = self.rpn(features)
        s_obj, s_reg = ([t.to(dev) for t in ts] for ts in side["rpn"])
        props = select_proposals(anchors, s_obj, s_reg, sizes, m["RPN"], False)
        s_boxes, _, s_valid = (t.to(dev) for t in side["proposals"])
        nhwc = [f.permute(0, 2, 3, 1).contiguous() for f in features]
        box_head = self._box_head_at(nhwc, s_boxes.float())
        s_logits, s_reg = (t.to(dev) for t in side["box_head"])
        det = box_head_inference(s_logits, s_reg, s_boxes, s_valid, sizes, m["ROI_HEADS"],
                                 m["ROI_HEADS"]["DETECTIONS_PER_IMG"])
        masks = self._masks_at(nhwc, side["detections"]["boxes"].to(dev).float(),
                               side["detections"]["labels"].to(dev))
        return {"rpn": rpn, "proposals": props, "box_head": box_head, "detections": det,
                "masks": masks}


def training_proposals(cfg, batch, rpn):
    """The proposal stage of a training step (gt appended) over the RPN
    head outputs `rpn` (objectness, bbox_reg per level) of the first images
    of `batch`: (boxes, scores, valid)."""
    obj, reg = rpn
    k = obj[0].shape[0]
    dev = batch["image_sizes"].device
    anchors = Anchors(cfg)
    grids = [anchors.grid(l, o.shape[2], o.shape[3], dev) for l, o in enumerate(obj)]
    gt_boxes = batch["gt_boxes"][:k].float()
    return select_proposals(grids, [o.to(dev) for o in obj], [r.to(dev) for r in reg],
                            batch["image_sizes"][:k], cfg["MODEL"]["RPN"], True, gt_boxes,
                            batch["gt_labels"][:k] > 0)


def calibrate(model, batch):
    """The body's normalisation set from the cell's first batch, under the
    name the harness calls: solver.calibrate_frozen_bn (frozen BNs)."""
    from .solver import calibrate_frozen_bn

    calibrate_frozen_bn(model, batch)
