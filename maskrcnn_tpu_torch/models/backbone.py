"""Backbone builder: ResNet C4/C5, ResNet + FPN (P2-P6), ResNet +
FPN-RetinaNet (P3-P7), or an FBNet body (one map at stride 16,
models/fbnet.py).

PyTorch counterpart of maskrcnn_tpu/models/backbone.py.
"""

import torch.nn as nn

from .fbnet import FBNetBackbone
from .fpn import FPN, LastLevelP6P7
from .resnet import ResNet


class ResNetC4(nn.Module):
    """The C4 (or C5) body alone: one map at stride 16 (32), of
    RESNETS.BACKBONE_OUT_CHANNELS channels (1024 for R-50-C4)."""

    def __init__(self, cfg):
        super().__init__()
        self.body = ResNet(cfg)
        self.out_channels = cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS
        self.strides = [16 if cfg.MODEL.BACKBONE.CONV_BODY.endswith("C4") else 32]

    def reset_parameters(self, gen):
        self.body.reset_parameters(gen)

    def forward(self, x):
        return self.body(x)


class ResNetFPN(nn.Module):
    """The standard FPN over C2-C5 with the max-pool P6; with
    retinanet=True the FPN over C3-C5 (C2's slot empty) and P6/P7 in
    ``top``, from C5 (RETINANET.USE_C5) or from P5. The FPN's convs take
    MODEL.FPN.USE_GN's group norm and USE_RELU's ReLU."""

    def __init__(self, cfg, retinanet=False):
        super().__init__()
        out2 = cfg.MODEL.RESNETS.RES2_OUT_CHANNELS
        self.body = ResNet(cfg)
        self.out_channels = cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS
        fpn = dict(gn_groups=cfg.MODEL.GROUP_NORM.NUM_GROUPS if cfg.MODEL.FPN.USE_GN else 0,
                   relu=cfg.MODEL.FPN.USE_RELU)
        if not retinanet:
            self.fpn = FPN([out2, out2 * 2, out2 * 4, out2 * 8], self.out_channels, **fpn)
            self.strides = [4, 8, 16, 32, 64]
            self.top = None
            return
        self.fpn = FPN([0, out2 * 2, out2 * 4, out2 * 8], self.out_channels, top_block=None,
                       **fpn)
        self.strides = [8, 16, 32, 64, 128]
        self.use_c5 = cfg.MODEL.RETINANET.USE_C5
        self.top = LastLevelP6P7(out2 * 8 if self.use_c5 else self.out_channels,
                                 self.out_channels)

    def reset_parameters(self, gen):
        self.body.reset_parameters(gen)
        self.fpn.reset_parameters(gen)
        if self.top is not None:
            self.top.reset_parameters(gen)

    def forward(self, x):
        features = self.body(x)
        results = self.fpn(features)
        if self.top is not None:
            results += self.top(features[-1] if self.use_c5 else results[-1])
        return results


def build_backbone(cfg):
    body = cfg.MODEL.BACKBONE.CONV_BODY
    if body.startswith("FBNet"):
        return FBNetBackbone(cfg)
    if "FPN" not in body:
        return ResNetC4(cfg)
    return ResNetFPN(cfg, retinanet="RETINANET" in body)
