"""ROI box head: feature extractors, predictors, training targets, loss
and inference.

PyTorch counterpart of maskrcnn_tpu/models/roi_heads/box_head.py: the
extractors FPN2MLPFeatureExtractor (two fcs), FPNXconv1fcFeatureExtractor
(NUM_STACKED_CONVS 3x3 convs, with a group norm each under USE_GN and a
bias only without, then fc6), ResNet50Conv5ROIFeatureExtractor (the C4
models' res5 head) and FBNet.roi_head (the FBNet bbox stages' blocks,
models/fbnet.py); the predictors FPNPredictor and FastRCNNPredictor (a
global average pool of a 4-d extractor output first); ``prepare_box_targets``
(match the proposals to the gt, sample a fixed ROI batch, encode its
targets) and ``box_head_loss``; and ``box_head_inference``: softmax,
per-class decode and clip, a top-k prefilter per (image, class) lane,
per-class NMS over all lanes at once (in a span "box_postproc.nms",
utils/profiling.py:span), and the top DETECTIONS_PER_IMG survivors per
image as padded outputs.

The pooled [R, P, P, C] features (and the Xconv head's conv output) are
flattened in (P, P, C) order, as the JAX head flattens its NHWC patches, so
fc6 converts from the JAX weight by a plain transpose. The res5 head
returns NCHW [R, 2048, P/2, P/2], the input of FastRCNNPredictor and of a
mask head that shares the extractor.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.box_ops import box_iou, clip_boxes_to_image, decode_boxes, encode_boxes
from ...ops.losses import smooth_l1_loss, softmax_cross_entropy
from ...ops.matcher import match_proposals
from ...ops.nms import NEG_INF, batched_nms
from ...ops.sampler import sample_topk_indices
from ...utils import comm
from ...utils.profiling import span
from ..fbnet import FBNetROIHead
from ..layers import ConvBlock, Linear, init_linear_
from ..resnet import ResNetHead
from ..rpn import top_k_stable


class FPN2MLPFeatureExtractor(nn.Module):
    def __init__(self, cfg, in_channels):
        super().__init__()
        res = cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
        dim = cfg.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM
        self.fc6 = Linear(in_channels * res * res, dim)
        self.fc7 = Linear(dim, dim)
        self.out_dim = dim

    def reset_parameters(self, gen):
        init_linear_(self.fc6, gen)
        init_linear_(self.fc7, gen)

    def forward(self, x):
        """x [R, P, P, C] -> [R, D]."""
        x = F.relu(self.fc6(x.reshape(x.shape[0], -1)))
        return F.relu(self.fc7(x))


class FPNXconv1fcFeatureExtractor(nn.Module):
    """NUM_STACKED_CONVS 3x3 convs of CONV_HEAD_DIM, each with a group norm
    (USE_GN) or a bias, and a ReLU; then fc6 and a ReLU."""

    def __init__(self, cfg, in_channels):
        super().__init__()
        h = cfg.MODEL.ROI_BOX_HEAD
        gn_groups = cfg.MODEL.GROUP_NORM.NUM_GROUPS if h.USE_GN else 0
        blocks, cin = [], in_channels
        for _ in range(h.NUM_STACKED_CONVS):
            blocks.append(ConvBlock(cin, h.CONV_HEAD_DIM, 3, gn_groups, relu=True,
                                    init="kaiming_normal_fanin"))
            cin = h.CONV_HEAD_DIM
        self.convs = nn.ModuleList(blocks)
        self.fc6 = Linear(cin * h.POOLER_RESOLUTION ** 2, h.MLP_HEAD_DIM)
        self.out_dim = h.MLP_HEAD_DIM

    def reset_parameters(self, gen):
        for blk in self.convs:
            blk.reset_parameters(gen)
        init_linear_(self.fc6, gen)

    def forward(self, x):
        """x [R, P, P, C] -> [R, D]."""
        x = x.permute(0, 3, 1, 2)
        for blk in self.convs:
            x = blk(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return F.relu(self.fc6(x))


class ResNet50Conv5ROIFeatureExtractor(nn.Module):
    """The C4 models' res5 head on the pooled ROIs: [R, P, P, C] (NHWC) ->
    NCHW [R, 2048, P/2, P/2] (stride 2 unless ROI_BOX_HEAD.DILATION > 1)."""

    def __init__(self, cfg, in_channels):
        super().__init__()
        self.head = ResNetHead(cfg)
        self.out_dim = self.head.out_channels

    def reset_parameters(self, gen):
        self.head.reset_parameters(gen)

    def forward(self, x):
        return self.head(x.permute(0, 3, 1, 2))


EXTRACTORS = {"FPN2MLPFeatureExtractor": FPN2MLPFeatureExtractor,
              "FPNXconv1fcFeatureExtractor": FPNXconv1fcFeatureExtractor,
              "ResNet50Conv5ROIFeatureExtractor": ResNet50Conv5ROIFeatureExtractor,
              "FBNet.roi_head": lambda cfg, c: FBNetROIHead(cfg, c, "bbox")}


class FPNPredictor(nn.Module):
    """cls_score and bbox_pred on [R, D]; as FastRCNNPredictor, the global
    average pool of a 4-d input (the res5 output) first."""

    def __init__(self, cfg, in_dim):
        super().__init__()
        num_classes = cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES
        num_reg = 2 if cfg.MODEL.CLS_AGNOSTIC_BBOX_REG else num_classes
        self.cls_score = Linear(in_dim, num_classes)
        self.bbox_pred = Linear(in_dim, num_reg * 4)

    def reset_parameters(self, gen):
        init_linear_(self.cls_score, gen, init="normal", std=0.01)
        init_linear_(self.bbox_pred, gen, init="normal", std=0.001)

    def forward(self, x):
        if x.ndim == 4:
            x = x.mean(dim=(2, 3))
        return self.cls_score(x).float(), self.bbox_pred(x).float()


class BoxHead(nn.Module):
    def __init__(self, cfg, in_channels):
        super().__init__()
        h = cfg.MODEL.ROI_BOX_HEAD
        if h.FEATURE_EXTRACTOR not in EXTRACTORS or h.PREDICTOR not in (
                "FPNPredictor", "FastRCNNPredictor"):
            raise NotImplementedError("box head {} + {} is not ported yet".format(
                h.FEATURE_EXTRACTOR, h.PREDICTOR))
        self.feature_extractor = EXTRACTORS[h.FEATURE_EXTRACTOR](cfg, in_channels)
        self.predictor = FPNPredictor(cfg, self.feature_extractor.out_dim)

    def reset_parameters(self, gen):
        self.feature_extractor.reset_parameters(gen)
        self.predictor.reset_parameters(gen)

    def forward(self, pooled):
        return self.predictor(self.feature_extractor(pooled))


def _take(x, idx):
    """x [B, N, ...] gathered along N at idx [B, K]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def prepare_box_targets(proposals, prop_valid, gt_boxes, gt_labels, pos_draw, neg_draw,
                        fg_iou, bg_iou, batch_per_image, positive_fraction, reg_weights,
                        gt_usable=None):
    """Match the proposals [B, P, 4] (valid [B, P]) to the gt (boxes
    [B, G, 4], labels [B, G], 0 = padding) and sample a fixed batch of
    K ROIs per image with the uniform draws pos_draw, neg_draw [B, P].
    gt_usable [B, G] (keypoint models: a gt with a visible joint inside its
    box): a proposal matched to a gt that is not usable is ignored (-1)
    before sampling.

    Returns a dict of rois [B, K, 4], labels [B, K] (0 background, -1
    unsampled), reg_targets [B, K, 4], valid, is_pos [B, K] and
    matched_gt_idx [B, K]."""
    iou = box_iou(gt_boxes, proposals)  # [B, G, P]
    iou = torch.where(prop_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    matched = match_proposals(iou, gt_labels > 0, fg_iou, bg_iou)  # [B, P]
    safe = matched.clamp(min=0).long()
    cls_labels = torch.where(matched >= 0, torch.gather(gt_labels, 1, safe).long(),
                             torch.where(matched == -1, 0, -1))
    cls_labels = torch.where(prop_valid, cls_labels, -1)
    if gt_usable is not None:
        usable = torch.gather(gt_usable, 1, safe)
        cls_labels = torch.where((matched >= 0) & ~usable, -1, cls_labels)
    idx, valid, is_pos = sample_topk_indices(cls_labels, pos_draw, neg_draw,
                                             batch_per_image, positive_fraction)
    rois = _take(proposals, idx)
    labels = torch.where(valid, torch.gather(cls_labels, 1, idx).clamp(min=0), -1)
    mg = torch.gather(safe, 1, idx)
    reg_targets = encode_boxes(_take(gt_boxes, mg), rois, reg_weights)
    return dict(rois=rois, labels=labels, reg_targets=reg_targets, valid=valid,
                is_pos=is_pos, matched_gt_idx=mg)


def box_head_loss(class_logits, box_regression, targets, cls_agnostic=False):
    """class_logits [B*K, C], box_regression [B*K, 4C] (or [B*K, 8]): the
    cross-entropy mean over the sampled ROIs, and smooth-L1 (beta 1) at the
    gt-class columns of the positives, summed over the sampled count; both
    counts those of the global batch in a process group."""
    labels = targets["labels"].reshape(-1)
    valid = targets["valid"].reshape(-1)
    is_pos = targets["is_pos"].reshape(-1) & valid
    reg_targets = targets["reg_targets"].reshape(-1, 4)
    cls_loss = softmax_cross_entropy(class_logits, labels, mask=valid)
    cols = torch.arange(4, device=labels.device)[None, :]
    if cls_agnostic:
        cols = cols + 4
    else:
        num_reg = box_regression.shape[-1] // 4
        cols = labels.clamp(0, num_reg - 1)[:, None] * 4 + cols
    picked = torch.gather(box_regression, 1, cols.expand(labels.shape[0], 4))
    l1 = smooth_l1_loss(picked, reg_targets, beta=1.0)
    n_sampled = comm.global_sum(valid.sum()).clamp(min=1)
    return cls_loss, (l1 * is_pos[:, None]).sum() / n_sampled


def box_head_inference(class_logits, box_regression, proposals, prop_valid,
                       image_sizes, reg_weights, score_thresh, nms_thresh,
                       detections_per_img, cls_agnostic=False):
    """class_logits [B, N, C], box_regression [B, N, 4C] (or [B, N, 8]),
    proposals [B, N, 4], prop_valid [B, N], image_sizes [B, 2] -> padded
    dict boxes [B, D, 4], scores [B, D], labels [B, D], valid [B, D]."""
    b, n, c = class_logits.shape
    probs = torch.softmax(class_logits, dim=-1)
    if cls_agnostic:
        decoded = decode_boxes(box_regression[..., 4:8], proposals, reg_weights)
        decoded = decoded[:, :, None, :].expand(b, n, c, 4)
    else:
        decoded = decode_boxes(box_regression, proposals, reg_weights).reshape(b, n, c, 4)
    h = image_sizes[:, 0:1].float()
    w = image_sizes[:, 1:2].float()
    decoded = clip_boxes_to_image(decoded.reshape(b, n * c, 4), (h, w)).reshape(b, n, c, 4)

    nc = c - 1
    cls_boxes = decoded[:, :, 1:, :].permute(0, 2, 1, 3).reshape(b * nc, n, 4)
    cls_scores = probs[:, :, 1:].permute(0, 2, 1).reshape(b * nc, n)
    cls_valid = (cls_scores > score_thresh) & prop_valid.repeat_interleave(nc, dim=0)

    k_nms = min(n, max(detections_per_img * 2, 128))
    masked = torch.where(cls_valid, cls_scores, torch.full_like(cls_scores, NEG_INF))
    top_sc, top_ix = top_k_stable(masked, k_nms)
    top_bx = torch.gather(cls_boxes, 1, top_ix[..., None].expand(-1, -1, 4))
    top_vl = top_sc > NEG_INF / 2

    with span("box_postproc.nms"):
        keep = batched_nms(top_bx, top_sc, top_vl, nms_thresh)  # [B*nc, k]

    kept = torch.where(keep, top_sc, torch.full_like(top_sc, NEG_INF)).reshape(b, nc * k_nms)
    out_scores, flat_idx = top_k_stable(kept, detections_per_img)
    out_valid = out_scores > NEG_INF / 2
    flat_boxes = top_bx.reshape(b, nc * k_nms, 4)
    out_boxes = torch.gather(flat_boxes, 1, flat_idx[..., None].expand(-1, -1, 4))
    out_boxes = torch.where(out_valid[..., None], out_boxes, torch.zeros_like(out_boxes))
    out_labels = torch.where(out_valid, flat_idx // k_nms + 1,
                             torch.zeros_like(flat_idx)).to(torch.int32)
    out_scores = torch.where(out_valid, out_scores, torch.zeros_like(out_scores))
    return dict(boxes=out_boxes, scores=out_scores, labels=out_labels, valid=out_valid)
