"""RetinaNet: the head's towers, focal-loss training, single-stage inference.

PyTorch counterpart of maskrcnn_tpu/models/retinanet.py (after the reference
maskrcnn_benchmark/modeling/rpn/retinanet/).

* ``RetinaNetHead``: 4-conv cls and bbox towers shared over the levels.
* ``retinanet_loss``: every anchor matched at FG_IOU / BG_IOU with the
  low-quality restore through the matcher kernel (ops/matcher.py
  ``match_anchors_batched``; the JAX loss builds the dense [G, N] IoU table
  and calls match_proposals, the function that kernel computes), labels
  from the gt, the focal loss over all anchors and classes divided by
  (positives + images), smooth-L1 over the positives divided by
  max(1, positives * BBOX_REG_WEIGHT). In a process group both counts are
  the global batch's, as in the JAX mesh step.
* ``retinanet_inference``: per level the threshold and the top
  PRE_NMS_TOP_N (anchor, class) scores, decoded; over the levels the top
  1000 an image, one NMS lane an image through the NMS kernel with the
  class-offset trick, then the top DETECTIONS_PER_IMG.

The box coder's weights are (10, 10, 5, 5) in the loss as in inference, as
maskrcnn-benchmark's single BoxCoder: the JAX loss encodes with (1, 1, 1, 1)
and decodes with (10, 10, 5, 5) (ROADMAP.md Queue 3).
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.box_ops import clip_boxes_to_image, decode_boxes, encode_boxes, small_box_mask
from ..ops.losses import sigmoid_focal_loss, smooth_l1_loss
from ..ops.matcher import match_anchors_batched
from ..ops.nms import NEG_INF, batched_nms
from ..ops.sampler import top_k_fast
from ..utils import comm
from .layers import Conv2d, init_conv_

BOX_CODER_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
# the class-offset trick: boxes of label l shifted by l * (MAX_COORD + 1)
MAX_COORD = 1e4


class RetinaNetHead(nn.Module):
    def __init__(self, cfg, in_channels):
        super().__init__()
        r = cfg.MODEL.RETINANET
        self.num_classes = r.NUM_CLASSES - 1
        a = len(r.ASPECT_RATIOS) * r.SCALES_PER_OCTAVE
        self.prior_prob = r.PRIOR_PROB
        self.cls_tower = nn.ModuleList(
            [Conv2d(in_channels, in_channels, 3, padding=1) for _ in range(r.NUM_CONVS)])
        self.bbox_tower = nn.ModuleList(
            [Conv2d(in_channels, in_channels, 3, padding=1) for _ in range(r.NUM_CONVS)])
        self.cls_logits = Conv2d(in_channels, a * self.num_classes, 3, padding=1)
        self.bbox_pred = Conv2d(in_channels, a * 4, 3, padding=1)

    def reset_parameters(self, gen):
        """Normal(0, 0.01) weights, zero biases, the cls bias at the prior
        -log((1 - pi) / pi)."""
        for conv in [*self.cls_tower, *self.bbox_tower, self.cls_logits, self.bbox_pred]:
            init_conv_(conv, gen, init="normal", std=0.01)
        with torch.no_grad():
            self.cls_logits.bias.fill_(-math.log((1 - self.prior_prob) / self.prior_prob))

    def forward(self, features):
        """features: list of [B, C, H, W] -> (cls logits [B, A*(K), H, W],
        box deltas [B, A*4, H, W]) per level, K the classes but background."""
        logits, bbox_reg = [], []
        for f in features:
            c, b = f, f
            for conv in self.cls_tower:
                c = F.relu(conv(c))
            for conv in self.bbox_tower:
                b = F.relu(conv(b))
            logits.append(self.cls_logits(c))
            bbox_reg.append(self.bbox_pred(b))
        return logits, bbox_reg


def retinanet_targets(anchors, gt_boxes, gt_labels, fg_iou, bg_iou):
    """anchors [N, 4], gt_boxes [B, G, 4], gt_labels [B, G] (0 = padding) ->
    (labels [B, N]: the matched gt's class, 0 background, -1 between the
    thresholds; matched [B, N] gt indices or the matcher's sentinels)."""
    matched = match_anchors_batched(anchors, gt_boxes, gt_labels > 0, fg_iou, bg_iou)
    gt_l = torch.gather(gt_labels, 1, matched.clamp(min=0).long())
    labels = torch.where(matched >= 0, gt_l,
                         torch.where(matched == -1, torch.zeros_like(gt_l), -torch.ones_like(gt_l)))
    return labels, matched


def retinanet_loss(anchors, box_cls, box_reg, gt_boxes, gt_labels, rcfg):
    """anchors [N, 4] (all levels), box_cls [B, N, K] logits and box_reg
    [B, N, 4] in the anchors' order, gt_boxes [B, G, 4], gt_labels [B, G].
    Returns (cls loss, reg loss)."""
    r = rcfg
    b = box_cls.shape[0]
    with torch.no_grad():
        labels, matched = retinanet_targets(anchors, gt_boxes, gt_labels, r.FG_IOU_THRESHOLD,
                                            r.BG_IOU_THRESHOLD)
        m_idx = matched.clamp(min=0).long()[..., None].expand(-1, -1, 4)
        reg_targets = encode_boxes(torch.gather(gt_boxes, 1, m_idx), anchors,
                                   BOX_CODER_WEIGHTS)
        pos = labels > 0
        num_pos = comm.global_sum(pos.sum())
        # a fill on the device: a host tensor copied over would wait for the card
        images = comm.global_sum(torch.full((), b, dtype=torch.int64, device=pos.device))
    fl = sigmoid_focal_loss(box_cls.float(), labels, r.LOSS_GAMMA, r.LOSS_ALPHA)
    cls_loss = fl.sum() / (num_pos + images)
    l1 = smooth_l1_loss(box_reg.float(), reg_targets, beta=r.BBOX_REG_BETA)
    reg_loss = (l1 * pos[..., None]).sum() / torch.clamp(num_pos * r.BBOX_REG_WEIGHT, min=1.0)
    return cls_loss, reg_loss


def retinanet_inference(anchors_per_level, cls_per_level, reg_per_level, image_sizes, rcfg,
                        detections_per_img):
    """anchors [Nl, 4], cls logits [B, A*K, Hl, Wl] and box deltas
    [B, A*4, Hl, Wl] per level (the head's NCHW outputs), image_sizes
    [B, 2] (h, w) -> the padded detection dict: boxes [B, D, 4], scores,
    labels and valid [B, D]."""
    r = rcfg
    num_classes = r.NUM_CLASSES - 1
    h = image_sizes[:, 0:1].float()
    w = image_sizes[:, 1:2].float()
    cand = []
    for anchors, cls, reg in zip(anchors_per_level, cls_per_level, reg_per_level):
        b = cls.shape[0]
        # (y, x, anchor, class) order, as the JAX NHWC flatten
        scores = torch.sigmoid(cls.float().permute(0, 2, 3, 1).reshape(b, -1))
        k = min(r.PRE_NMS_TOP_N, scores.shape[1])
        masked = torch.where(scores > r.INFERENCE_TH, scores, torch.full_like(scores, NEG_INF))
        # tie order unspecified, as the JAX top_k_fast's
        top_scores, top_idx = torch.topk(masked, k, dim=-1)
        valid = top_scores > NEG_INF / 2
        anchor_idx = torch.div(top_idx, num_classes, rounding_mode="floor")
        label = top_idx % num_classes + 1
        deltas = reg.float().permute(0, 2, 3, 1).reshape(b, -1, 4)
        deltas = torch.gather(deltas, 1, anchor_idx[..., None].expand(-1, -1, 4))
        boxes = decode_boxes(deltas, anchors[anchor_idx], BOX_CODER_WEIGHTS)
        boxes = clip_boxes_to_image(boxes, (h, w))
        valid = valid & small_box_mask(boxes, 0)  # the JAX cfg's min_size
        cand.append((boxes, torch.where(valid, top_scores, torch.zeros_like(top_scores)),
                     label, valid))
    boxes, scores, labels, valid = (torch.cat(x, dim=1) for x in zip(*cand))

    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    top_sc, top_ix = top_k_fast(masked, min(scores.shape[1], 1000))
    top_bx = torch.gather(boxes, 1, top_ix[..., None].expand(-1, -1, 4))
    top_lb = torch.gather(labels, 1, top_ix)
    top_vl = top_sc > NEG_INF / 2
    offset = top_bx + top_lb.to(top_bx.dtype)[..., None] * (MAX_COORD + 1.0)
    keep = batched_nms(offset, top_sc, top_vl, r.NMS_TH)
    kept = torch.where(keep, top_sc, torch.full_like(top_sc, NEG_INF))
    out_scores, idx = top_k_fast(kept, detections_per_img)
    out_valid = out_scores > NEG_INF / 2
    ob = torch.gather(top_bx, 1, idx[..., None].expand(-1, -1, 4))
    return {
        "boxes": torch.where(out_valid[..., None], ob, torch.zeros_like(ob)),
        "scores": torch.where(out_valid, out_scores, torch.zeros_like(out_scores)),
        "labels": torch.where(out_valid, torch.gather(top_lb, 1, idx),
                              torch.zeros_like(idx)).to(torch.int32),
        "valid": out_valid,
    }
