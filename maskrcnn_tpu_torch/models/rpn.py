"""Region Proposal Network: head, fixed-shape proposal selection, loss.

PyTorch counterpart of maskrcnn_tpu/models/rpn.py: the shared 3x3 conv with
the cls and reg 1x1 convs run as one merged conv; ``select_proposals``:
per-level top-k, decode, clip, one batched NMS over all (level, image)
lanes, per-lane top-k, then the FPN top-k over the concatenated levels (in
training over the whole batch, FPN_POST_NMS_PER_BATCH, with the gt boxes
appended); and ``rpn_loss``: anchor matcher, balanced sampler, BCE and
smooth-L1 over the sampled anchors.

In a process group (one process a card, each with its share of the global
batch) the batch-wide reductions are global, as the JAX mesh step's: the
FPN top-k's k-th score is taken over every process's scores
(``comm.gather_rows``) and the RPN losses divide by the sampled anchors of
the whole global batch (``comm.global_sum``).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.box_ops import clip_boxes_to_image, decode_boxes, encode_boxes, small_box_mask
from ..ops.losses import binary_cross_entropy_with_logits, smooth_l1_loss
from ..ops.matcher import match_anchors_batched
from ..ops.nms import NEG_INF, batched_nms
from ..ops.sampler import sample_topk_indices
from ..utils import comm
from .layers import Conv2d, init_conv_


def top_k_stable(x, k):
    """lax.top_k semantics: descending, ties broken by lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k_fast(x, k):
    """The JAX package's top_k_fast: lax.top_k's values; below 8192 entries
    or for k < 64 its index order too (top_k_stable), above that the order
    within tied values is open (JAX takes approx_max_k there), and
    torch.topk takes its place."""
    if x.shape[-1] >= 8192 and k >= 64:
        return torch.topk(x, k, dim=-1)
    return top_k_stable(x, k)


class RPNHead(nn.Module):
    def __init__(self, in_channels, num_anchors):
        super().__init__()
        self.conv = Conv2d(in_channels, in_channels, 3, padding=1)
        self.cls_logits = Conv2d(in_channels, num_anchors, 1)
        self.bbox_pred = Conv2d(in_channels, num_anchors * 4, 1)

    def reset_parameters(self, gen):
        for conv in (self.conv, self.cls_logits, self.bbox_pred):
            init_conv_(conv, gen, init="normal", std=0.01)

    def forward(self, features):
        """features: list of [B, C, H, W] -> (objectness [B, A, H, W],
        bbox_reg [B, 4A, H, W]) per level. The two 1x1 convs run as one."""
        a = self.cls_logits.out_channels
        w = torch.cat([self.cls_logits.weight, self.bbox_pred.weight])
        b = torch.cat([self.cls_logits.bias, self.bbox_pred.bias])
        objectness, bbox_reg = [], []
        for f in features:
            t = F.relu(self.conv(f))
            o = F.conv2d(t, w.to(t.dtype), b.to(t.dtype))
            objectness.append(o[:, :a])
            bbox_reg.append(o[:, a:])
        return objectness, bbox_reg


def _level_candidates(anchors, objectness, bbox_reg, image_hw, pre_nms_top_n,
                      min_size):
    """anchors [N, 4], objectness [B, N], bbox_reg [B, N, 4] -> boxes
    [B, k, 4], scores [B, k], valid [B, k] for the level's top-k."""
    b, n = objectness.shape
    k = min(pre_nms_top_n, n)
    scores = torch.sigmoid(objectness.float())
    top_scores, top_idx = top_k_fast(scores, k)
    top_deltas = torch.gather(bbox_reg.float(), 1, top_idx[..., None].expand(-1, -1, 4))
    boxes = decode_boxes(top_deltas, anchors[top_idx])
    boxes = clip_boxes_to_image(boxes, image_hw)
    return boxes, top_scores, small_box_mask(boxes, min_size)


def _pad_to(x, k, fill):
    pad = k - x.shape[1]
    if pad == 0:
        return x
    shape = (x.shape[0], pad) + tuple(x.shape[2:])
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], dim=1)


def select_proposals(anchors_per_level, objectness_per_level, bbox_reg_per_level,
                     image_sizes, rpn_cfg, is_train=False, gt_boxes=None, gt_valid=None):
    """Proposals. objectness [B, A, H, W] and bbox_reg [B, 4A, H, W] per
    level (NCHW head outputs); image_sizes [B, 2] (h, w); in training the gt
    boxes [B, G, 4] and gt_valid [B, G] are appended with score 1. Returns
    boxes [B, P, 4], scores [B, P], valid [B, P]. Nothing here carries a
    gradient: callers pass detached head outputs."""
    phase = "TRAIN" if is_train else "TEST"
    pre_nms = rpn_cfg["PRE_NMS_TOP_N_" + phase]
    post_nms = rpn_cfg["POST_NMS_TOP_N_" + phase]
    fpn_post = rpn_cfg["FPN_POST_NMS_TOP_N_" + phase]
    h = image_sizes[:, 0:1].float()
    w = image_sizes[:, 1:2].float()
    num_levels = len(anchors_per_level)
    cand = []
    for anchors, obj, reg in zip(anchors_per_level, objectness_per_level,
                                 bbox_reg_per_level):
        b, a = obj.shape[0], obj.shape[1]
        # (h, w, a) order, as the JAX NHWC flatten
        obj = obj.permute(0, 2, 3, 1).reshape(b, -1)
        reg = reg.permute(0, 2, 3, 1).reshape(b, -1, a, 4).reshape(b, -1, 4)
        cand.append(_level_candidates(anchors, obj, reg, (h, w), pre_nms,
                                      rpn_cfg.MIN_SIZE))

    b = cand[0][1].shape[0]
    k_max = max(c[1].shape[1] for c in cand)
    sb = torch.cat([_pad_to(c[0], k_max, 0.0) for c in cand])
    ss = torch.cat([_pad_to(c[1], k_max, NEG_INF) for c in cand])
    sv = torch.cat([_pad_to(c[2], k_max, False) for c in cand])
    keep = batched_nms(sb, ss, sv, rpn_cfg.NMS_THRESH)  # [L*B, k_max]

    masked = torch.where(keep, ss, torch.full_like(ss, NEG_INF))
    k_post = min(post_nms, k_max)
    sel_scores, sel = top_k_stable(masked, k_post)
    sel_valid = sel_scores > NEG_INF / 2
    sel_boxes = torch.gather(sb, 1, sel[..., None].expand(-1, -1, 4))
    sel_boxes = torch.where(sel_valid[..., None], sel_boxes, torch.zeros_like(sel_boxes))
    sel_scores = torch.where(sel_valid, sel_scores, torch.zeros_like(sel_scores))
    # [L*B, k] -> [B, L*k], level-major per image
    boxes = sel_boxes.reshape(num_levels, b, k_post, 4).transpose(0, 1).reshape(b, -1, 4)
    scores = sel_scores.reshape(num_levels, b, k_post).transpose(0, 1).reshape(b, -1)
    valid = sel_valid.reshape(num_levels, b, k_post).transpose(0, 1).reshape(b, -1)

    if num_levels > 1:
        k = min(fpn_post, scores.shape[1])
        masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
        if is_train and rpn_cfg.FPN_POST_NMS_PER_BATCH:
            # the Detectron quirk: in training the FPN top-k runs over the
            # whole (global) batch; a rank threshold keeps the per-image shape
            flat = comm.gather_rows(masked).reshape(-1)
            kth = torch.topk(flat, min(fpn_post, flat.numel())).values[-1]
            keep = masked >= torch.clamp(kth, min=NEG_INF / 2)
            masked = torch.where(keep, masked, torch.full_like(masked, NEG_INF))
        sel_scores, sel = top_k_fast(masked, k)
        valid = sel_scores > NEG_INF / 2
        boxes = torch.gather(boxes, 1, sel[..., None].expand(-1, -1, 4))
        boxes = torch.where(valid[..., None], boxes, torch.zeros_like(boxes))
        scores = torch.where(valid, sel_scores, torch.zeros_like(sel_scores))
    if is_train and gt_boxes is not None:
        boxes = torch.cat([boxes, gt_boxes.to(boxes.dtype)], dim=1)
        scores = torch.cat([scores, gt_valid.to(scores.dtype)], dim=1)
        valid = torch.cat([valid, gt_valid], dim=1)
    return boxes, scores, valid


def rpn_loss(anchors, visible, objectness, bbox_reg, gt_boxes, gt_valid, pos_draw,
             neg_draw, fg_iou, bg_iou, batch_per_image, positive_fraction):
    """anchors [N, 4] (all levels), visible [B, N] bool, objectness [B, N]
    logits and bbox_reg [B, N, 4] in the anchors' order, gt_boxes [B, G, 4],
    gt_valid [B, G], the sampler's uniform draws pos_draw and neg_draw
    [B, N]. Returns (objectness loss, box loss), both normalised by the
    number of sampled anchors in the global batch."""
    matched = match_anchors_batched(anchors, gt_boxes, gt_valid, fg_iou, bg_iou)
    labels = torch.where(matched >= 0, 1, torch.where(matched == -1, 0, -1))
    labels = torch.where(visible, labels, -1)
    idx, valid, is_pos = sample_topk_indices(labels, pos_draw, neg_draw, batch_per_image,
                                             positive_fraction)  # [B, K]
    m_idx = torch.gather(matched, 1, idx).clamp(min=0).long()
    gt_sel = torch.gather(gt_boxes, 1, m_idx[..., None].expand(-1, -1, 4))
    reg_t = encode_boxes(gt_sel, anchors[idx])
    obj_s = torch.gather(objectness, 1, idx)
    reg_s = torch.gather(bbox_reg, 1, idx[..., None].expand(-1, -1, 4))
    n_sampled = comm.global_sum(valid.sum()).clamp(min=1)
    box_l = smooth_l1_loss(reg_s.float(), reg_t, beta=1.0 / 9)
    box_loss = (box_l * is_pos[..., None]).sum() / n_sampled
    obj_l = binary_cross_entropy_with_logits(obj_s.float(), is_pos.float())
    return (obj_l * valid).sum() / n_sampled, box_loss
