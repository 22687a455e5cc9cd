"""ROI mask head: its extractor, its predictor, and the training pieces.

PyTorch counterpart of maskrcnn_tpu/models/roi_heads/mask_head.py:
MaskRCNNC4Predictor (deconv, then a 1x1 conv) after
MaskRCNNFPNFeatureExtractor (4 convs), after ResNet50Conv5ROIFeatureExtractor
(the res5 head), or, under SHARE_BOX_FEATURE_EXTRACTOR (the C4 mask files),
after the box head's own extractor: the mask head then holds no extractor,
and the detector hands it that extractor's output; and
MaskRCNNConv1x1Predictor (the 1x1 conv alone) after FBNet.roi_head_mask (the
FBNet mask stages' blocks, which upsample to RESOLUTION themselves). Full
logits at inference; in training the logits of each ROI's gt class only
(``MaskHead.logits_at_class``), the positive-ROI selection, the projection
of the gt mask patches into the ROI frames, and the BCE loss.

ROI_MASK_HEAD.USE_GN gives each of the extractor's convs no bias and a
group norm of MODEL.GROUP_NORM.NUM_GROUPS after it, before its ReLU, as
maskrcnn-benchmark's make_conv3x3(use_gn=True) does. The JAX package's mask
head ignores the key (ROADMAP.md Queue 3), so a GN mask head is held to the
benchmark's plain reference (benchmark/reference/mask_rcnn_gn.py), not to
JAX.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.sampler import top_k_fast
from ...utils import comm
from ..fbnet import FBNetROIHead
from ..layers import Conv2d, ConvBlock, ConvTranspose2d, full_weight, init_conv_
from .box_head import ResNet50Conv5ROIFeatureExtractor


class MaskRCNNFPNFeatureExtractor(nn.Module):
    def __init__(self, cfg, in_channels):
        super().__init__()
        h = cfg.MODEL.ROI_MASK_HEAD
        gn_groups = cfg.MODEL.GROUP_NORM.NUM_GROUPS if h.USE_GN else 0
        blocks, cin = [], in_channels
        for cout in h.CONV_LAYERS:
            blocks.append(ConvBlock(cin, cout, 3, gn_groups, relu=True, dilation=h.DILATION,
                                    init="kaiming_normal_fanin"))
            cin = cout
        self.convs = nn.ModuleList(blocks)
        self.out_dim = cin

    def reset_parameters(self, gen):
        for blk in self.convs:
            blk.reset_parameters(gen)

    def forward(self, x):
        """[R, P, P, C] (NHWC) -> NCHW [R, D, P, P]."""
        x = x.permute(0, 3, 1, 2)
        for blk in self.convs:
            x = blk(x)
        return x


EXTRACTORS = {"MaskRCNNFPNFeatureExtractor": MaskRCNNFPNFeatureExtractor,
              "ResNet50Conv5ROIFeatureExtractor": ResNet50Conv5ROIFeatureExtractor,
              "FBNet.roi_head_mask": lambda cfg, c: FBNetROIHead(cfg, c, "mask")}


class MaskRCNNC4Predictor(nn.Module):
    def __init__(self, cfg, in_channels):
        super().__init__()
        dim_reduced = cfg.MODEL.ROI_MASK_HEAD.CONV_LAYERS[-1]
        num_classes = cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES
        self.conv5_mask = ConvTranspose2d(in_channels, dim_reduced, 2, stride=2)
        self.mask_fcn_logits = Conv2d(dim_reduced, num_classes, 1)

    def reset_parameters(self, gen):
        with torch.no_grad():
            w = torch.randn(self.conv5_mask.weight.shape, generator=gen) * 0.001
            self.conv5_mask.weight.copy_(w)
            self.conv5_mask.bias.zero_()
        init_conv_(self.mask_fcn_logits, gen, init="kaiming_normal_fanin")

    def upsample(self, x):
        """[R, C, M/2, M/2] -> the 1x1 conv's input [R, D, M, M]."""
        return F.relu(self.conv5_mask(x))

    def forward(self, x):
        """[R, C, M/2, M/2] -> logits [R, num_classes, M, M] float32."""
        return self.mask_fcn_logits(self.upsample(x)).float()


class MaskRCNNConv1x1Predictor(nn.Module):
    def __init__(self, cfg, in_channels):
        super().__init__()
        self.mask_fcn_logits = Conv2d(in_channels, cfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES, 1)

    def reset_parameters(self, gen):
        init_conv_(self.mask_fcn_logits, gen, init="kaiming_normal_fanin")

    def upsample(self, x):
        return x

    def forward(self, x):
        """[R, C, M, M] -> logits [R, num_classes, M, M] float32."""
        return self.mask_fcn_logits(x).float()


PREDICTORS = {"MaskRCNNC4Predictor": MaskRCNNC4Predictor,
              "MaskRCNNConv1x1Predictor": MaskRCNNConv1x1Predictor}


class MaskHead(nn.Module):
    """shared_dim: the width of the box head's extractor output when the
    mask head shares it (SHARE_BOX_FEATURE_EXTRACTOR), else None."""

    def __init__(self, cfg, in_channels, shared_dim=None):
        super().__init__()
        h = cfg.MODEL.ROI_MASK_HEAD
        if h.FEATURE_EXTRACTOR not in EXTRACTORS or h.PREDICTOR not in PREDICTORS:
            raise NotImplementedError("mask head {} + {} is not ported yet".format(
                h.FEATURE_EXTRACTOR, h.PREDICTOR))
        if shared_dim is None:
            self.feature_extractor = EXTRACTORS[h.FEATURE_EXTRACTOR](cfg, in_channels)
            shared_dim = self.feature_extractor.out_dim
        else:
            self.feature_extractor = None
        self.predictor = PREDICTORS[h.PREDICTOR](cfg, shared_dim)

    def reset_parameters(self, gen):
        if self.feature_extractor is not None:
            self.feature_extractor.reset_parameters(gen)
        self.predictor.reset_parameters(gen)

    def features(self, x):
        """The predictor's NCHW input: the head's extractor on the pooled
        [R, P, P, C] (NHWC), or x itself, the shared extractor's output."""
        return x if self.feature_extractor is None else self.feature_extractor(x)

    def forward(self, x, labels):
        """x (see ``features``), labels [R] -> mask probabilities [R, M, M]
        of each ROI's own class."""
        logits = self.predictor(self.features(x))
        safe = labels.long().clamp(0, logits.shape[1] - 1)
        picked = logits[torch.arange(logits.shape[0], device=logits.device), safe]
        return torch.sigmoid(picked)

    def logits_at_class(self, x, labels):
        """Training: x (see ``features``), labels [R] -> float32 logits
        [R, M, M] of each ROI's label only. The 1x1 predictor's weight column
        of that class is gathered first, so the other classes' maps are
        never computed (apply_mask_predictor_at_class); under the model axis
        from the whole weight."""
        x = self.predictor.upsample(self.features(x))
        fcn = self.predictor.mask_fcn_logits
        safe = labels.long().clamp(0, fcn.out_channels - 1)
        wl = full_weight(fcn)[:, :, 0, 0][safe].to(x.dtype)  # [R, D]
        out = torch.einsum("rdhw,rd->rhw", x, wl)
        return (out + fcn.bias[safe].to(x.dtype)[:, None, None]).float()


def select_positive_rois(targets, k_mask):
    """The first k_mask positive ROIs of each image's sampled batch
    (positives come first): (idx [B, Km], valid [B, Km])."""
    is_pos = targets["is_pos"] & targets["valid"]
    k = is_pos.shape[1]
    score = is_pos.float() - torch.arange(k, device=is_pos.device)[None, :] * 1e-6
    top, idx = top_k_fast(score, min(k_mask, k))
    return idx, top > 0.5


def project_gt_masks(gt_patches, gt_boxes, proposal_boxes, out_size):
    """Resample gt mask patches into proposal crop frames.

    gt_patches [R, S, S] (the matched instance's mask over its gt box),
    gt_boxes [R, 4], proposal_boxes [R, 4] -> [R, M, M] float targets in
    [0, 1]: bilinear samples at the M x M output pixel centres, zero
    outside the patch."""
    r, s, _ = gt_patches.shape
    m = out_size
    gx1, gy1, gx2, gy2 = gt_boxes.unbind(-1)
    px1, py1, px2, py2 = proposal_boxes.unbind(-1)
    gw = (gx2 - gx1).clamp(min=1.0)
    gh = (gy2 - gy1).clamp(min=1.0)
    pw = (px2 - px1).clamp(min=1.0)
    ph = (py2 - py1).clamp(min=1.0)
    u = (torch.arange(m, dtype=torch.float32, device=gt_boxes.device) + 0.5) / m
    x_img = px1[:, None] + u[None, :] * pw[:, None]
    y_img = py1[:, None] + u[None, :] * ph[:, None]
    size = torch.full_like(gw, float(s))
    xq = (x_img - gx1[:, None]) * (size / gw)[:, None] - 0.5
    yq = (y_img - gy1[:, None]) * (size / gh)[:, None] - 0.5

    patches = gt_patches.float()
    y0 = torch.floor(yq).long()
    x0 = torch.floor(xq).long()
    wy = (yq - y0)[:, :, None]
    wx = (xq - x0)[:, None, :]
    rows = torch.arange(r, device=patches.device)[:, None, None]

    def corner(yi, xi):
        inside = (((yi >= 0) & (yi <= s - 1))[:, :, None]
                  & ((xi >= 0) & (xi <= s - 1))[:, None, :])
        v = patches[rows, yi.clamp(0, s - 1)[:, :, None], xi.clamp(0, s - 1)[:, None, :]]
        return v * inside

    return (corner(y0, x0) * (1 - wy) * (1 - wx) + corner(y0, x0 + 1) * (1 - wy) * wx
            + corner(y0 + 1, x0) * wy * (1 - wx) + corner(y0 + 1, x0 + 1) * wy * wx)


def mask_head_loss_picked(picked, mask_targets, valid):
    """BCE of the gt-class logits [R, M, M] against the targets binarised
    at 0.5, mean over the valid ROIs' pixels (of the global batch in a
    process group)."""
    m = picked.shape[1]
    t = (mask_targets >= 0.5).float()
    per = F.softplus(picked) - picked * t
    w = valid.float()[:, None, None]
    return (per * w).sum() / (comm.global_sum(w.sum()) * m * m).clamp(min=1.0)
