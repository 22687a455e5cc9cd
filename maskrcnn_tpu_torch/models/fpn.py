"""Feature Pyramid Network with the LastLevelMaxPool P6 block.

PyTorch counterpart of maskrcnn_tpu/models/fpn.py (R-CNN variant): lateral
1x1 convs, top-down 2x nearest upsampling, 3x3 output convs, and P6 as the
1x1/stride-2 max pool of P5, which is a plain stride-2 subsample. The GN,
ReLU and P6/P7 (RetinaNet) options wait for their model families.
"""

import torch.nn as nn

from .layers import Conv2d, init_conv_, nearest_upsample2x


class _ConvBlock(nn.Module):
    """Holds one conv under the name the JAX param tree uses ("conv")."""

    def __init__(self, cin, cout, k):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, padding=k // 2)

    def forward(self, x):
        return self.conv(x)


class FPN(nn.Module):
    def __init__(self, in_channels_list, out_channels):
        super().__init__()
        self.inner = nn.ModuleList(
            [_ConvBlock(c, out_channels, 1) for c in in_channels_list]
        )
        self.layer = nn.ModuleList(
            [_ConvBlock(out_channels, out_channels, 3) for _ in in_channels_list]
        )

    def reset_parameters(self, gen):
        for inner, layer in zip(self.inner, self.layer):
            init_conv_(inner.conv, gen, init="kaiming_uniform")
            init_conv_(layer.conv, gen, init="kaiming_uniform")

    def forward(self, features):
        """features [C2..C5] -> [P2..P5, P6]."""
        last_inner = self.inner[-1](features[-1])
        results = [self.layer[-1](last_inner)]
        for feature, inner, layer in zip(
            features[-2::-1], self.inner[-2::-1], self.layer[-2::-1]
        ):
            last_inner = inner(feature) + nearest_upsample2x(last_inner)
            results.insert(0, layer(last_inner))
        results.append(results[-1][:, :, ::2, ::2])
        return results
