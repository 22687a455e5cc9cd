"""Backbone builder: ResNet + FPN (P2-P6), or ResNet + FPN-RetinaNet (P3-P7).

PyTorch counterpart of the FPN branches of maskrcnn_tpu/models/backbone.py.
The C4/C5 and FBNet bodies wait for their model families.
"""

import torch.nn as nn

from .fpn import FPN, LastLevelP6P7
from .resnet import ResNet


class ResNetFPN(nn.Module):
    """The standard FPN over C2-C5 with the max-pool P6; with
    retinanet=True the FPN over C3-C5 (C2's slot empty) and P6/P7 in
    ``top``, from C5 (RETINANET.USE_C5) or from P5."""

    def __init__(self, cfg, retinanet=False):
        super().__init__()
        out2 = cfg.MODEL.RESNETS.RES2_OUT_CHANNELS
        self.body = ResNet(cfg)
        self.out_channels = cfg.MODEL.RESNETS.BACKBONE_OUT_CHANNELS
        if not retinanet:
            self.fpn = FPN([out2, out2 * 2, out2 * 4, out2 * 8], self.out_channels)
            self.strides = [4, 8, 16, 32, 64]
            self.top = None
            return
        self.fpn = FPN([0, out2 * 2, out2 * 4, out2 * 8], self.out_channels, top_block=None)
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
    if "FPN" not in body or body.startswith("FBNet"):
        raise NotImplementedError("backbone {} is not ported yet".format(body))
    if cfg.MODEL.FPN.USE_GN or cfg.MODEL.FPN.USE_RELU:
        raise NotImplementedError("FPN GN/ReLU variants are not ported yet")
    return ResNetFPN(cfg, retinanet="RETINANET" in body)
