"""ROI mask head (FPN): 4-conv extractor and the deconv + 1x1 predictor.

PyTorch counterpart of maskrcnn_tpu/models/roi_heads/mask_head.py for the
MaskRCNNFPNFeatureExtractor + MaskRCNNC4Predictor pair used at inference.
The training-only pieces (gt-class logits, target projection, loss) are
the next slice.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv2d, ConvTranspose2d, init_conv_


class _ConvBlock(nn.Module):
    def __init__(self, cin, cout, dilation):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3, padding=dilation, dilation=dilation)


class MaskRCNNFPNFeatureExtractor(nn.Module):
    def __init__(self, cfg, in_channels):
        super().__init__()
        h = cfg.MODEL.ROI_MASK_HEAD
        if h.USE_GN:
            raise NotImplementedError("GN mask head is not ported yet")
        blocks, cin = [], in_channels
        for cout in h.CONV_LAYERS:
            blocks.append(_ConvBlock(cin, cout, h.DILATION))
            cin = cout
        self.convs = nn.ModuleList(blocks)
        self.out_channels = cin

    def reset_parameters(self, gen):
        for blk in self.convs:
            init_conv_(blk.conv, gen, init="kaiming_normal_fanin")

    def forward(self, x):
        for blk in self.convs:
            x = F.relu(blk.conv(x))
        return x


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

    def forward(self, x):
        """[R, C, M/2, M/2] -> logits [R, num_classes, M, M] float32."""
        x = F.relu(self.conv5_mask(x))
        return self.mask_fcn_logits(x).float()


class MaskHead(nn.Module):
    def __init__(self, cfg, in_channels):
        super().__init__()
        h = cfg.MODEL.ROI_MASK_HEAD
        if (h.FEATURE_EXTRACTOR != "MaskRCNNFPNFeatureExtractor"
                or h.PREDICTOR != "MaskRCNNC4Predictor"
                or h.SHARE_BOX_FEATURE_EXTRACTOR):
            raise NotImplementedError("mask head {} + {} is not ported yet".format(
                h.FEATURE_EXTRACTOR, h.PREDICTOR))
        self.feature_extractor = MaskRCNNFPNFeatureExtractor(cfg, in_channels)
        self.predictor = MaskRCNNC4Predictor(cfg, self.feature_extractor.out_channels)

    def reset_parameters(self, gen):
        self.feature_extractor.reset_parameters(gen)
        self.predictor.reset_parameters(gen)

    def forward(self, pooled, labels):
        """pooled [R, P, P, C] (NHWC), labels [R] -> mask probabilities
        [R, M, M] of each ROI's own class."""
        x = self.feature_extractor(pooled.permute(0, 3, 1, 2))
        logits = self.predictor(x)
        safe = labels.long().clamp(0, logits.shape[1] - 1)
        picked = logits[torch.arange(logits.shape[0], device=logits.device), safe]
        return torch.sigmoid(picked)
