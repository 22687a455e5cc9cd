"""Feature Pyramid Network with its two extra-level blocks.

PyTorch counterpart of maskrcnn_tpu/models/fpn.py: lateral 1x1 convs,
top-down 2x nearest upsampling, 3x3 output convs; then either P6 as the
1x1/stride-2 max pool of P5, which is a plain stride-2 subsample (R-CNN),
or ``LastLevelP6P7`` (RetinaNet). With MODEL.FPN.USE_GN each conv loses its
bias and is followed by a group norm; with USE_RELU each output conv (not
the laterals) by a ReLU, in that order (JAX ``fpn._block``).

A level of zero input channels keeps its slot empty (None), as the JAX
``init_fpn`` does: RetinaNet's FPN over C3-C5 has modules 1-3, so that the
names line up with the JAX tree and with the reference's fpn_inner2..4.
"""

import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, ConvBlock, init_conv_, nearest_upsample2x


class FPN(nn.Module):
    """gn_groups: the group norm's groups (0 without one); relu: a ReLU
    after each output conv."""

    def __init__(self, in_channels_list, out_channels, top_block="maxpool", gn_groups=0,
                 relu=False):
        super().__init__()
        self.inner = nn.ModuleList(
            [ConvBlock(c, out_channels, 1, gn_groups) if c else None for c in in_channels_list]
        )
        self.layer = nn.ModuleList(
            [ConvBlock(out_channels, out_channels, 3, gn_groups, relu) if c else None
             for c in in_channels_list]
        )
        self.top_block = top_block

    def reset_parameters(self, gen):
        for inner, layer in zip(self.inner, self.layer):
            if inner is not None:
                inner.reset_parameters(gen)
                layer.reset_parameters(gen)

    def forward(self, features):
        """features [C2..C5] -> [P2..P5] and, with the max-pool block, P6
        (the levels of empty slots left out)."""
        last_inner = self.inner[-1](features[-1])
        results = [self.layer[-1](last_inner)]
        for feature, inner, layer in zip(
            features[-2::-1], self.inner[-2::-1], self.layer[-2::-1]
        ):
            if inner is None:
                continue
            last_inner = inner(feature) + nearest_upsample2x(last_inner)
            results.insert(0, layer(last_inner))
        if self.top_block == "maxpool":
            results.append(results[-1][:, :, ::2, ::2])
        return results


class LastLevelP6P7(nn.Module):
    """RetinaNet's P6 (3x3 stride-2 conv of C5, or of P5 when the input
    width is the FPN's) and P7 (3x3 stride-2 conv of relu(P6))."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.p6 = Conv2d(in_channels, out_channels, 3, stride=2, padding=1)
        self.p7 = Conv2d(out_channels, out_channels, 3, stride=2, padding=1)

    def reset_parameters(self, gen):
        init_conv_(self.p6, gen, init="kaiming_uniform")
        init_conv_(self.p7, gen, init="kaiming_uniform")

    def forward(self, x):
        p6 = self.p6(x)
        return [p6, self.p7(F.relu(p6))]
