"""Backbone builder: ResNet + FPN (P2-P6).

PyTorch counterpart of the standard-FPN branch of
maskrcnn_tpu/models/backbone.py. The C4/C5, RetinaNet and FBNet bodies wait
for their model families.
"""

import torch.nn as nn

from .fpn import FPN
from .resnet import ResNet


class ResNetFPN(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        out2 = cfg.MODEL.RESNETS.RES2_OUT_CHANNELS
        self.body = ResNet(cfg)
        self.out_channels = cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS
        self.fpn = FPN([out2, out2 * 2, out2 * 4, out2 * 8], self.out_channels)
        self.strides = [4, 8, 16, 32, 64]

    def reset_parameters(self, gen):
        self.body.reset_parameters(gen)
        self.fpn.reset_parameters(gen)

    def forward(self, x):
        return self.fpn(self.body(x))


def build_backbone(cfg):
    body = cfg.MODEL.BACKBONE.CONV_BODY
    if "FPN" not in body or "RETINANET" in body or body.startswith("FBNet"):
        raise NotImplementedError("backbone {} is not ported yet".format(body))
    if cfg.MODEL.FPN.USE_GN or cfg.MODEL.FPN.USE_RELU:
        raise NotImplementedError("FPN GN/ReLU variants are not ported yet")
    return ResNetFPN(cfg)
