"""ResNet / ResNeXt body with frozen BN.

PyTorch counterpart of maskrcnn_tpu/models/resnet.py. Every frozen BN is
folded into the conv before it (conv_frozen_bn), the same algebra as the
JAX ``conv_norm``. The stem is the plain 7x7/stride-2/pad-3 conv: the JAX
package's space-to-depth stem is a TPU rewrite of the same math. Group norm
and deformable convs belong to other model families and are not ported yet.

Training: the stem and the first FREEZE_CONV_BODY_AT - 1 stages are frozen
(their parameters do not require grad, so the optimizer skips them), and
TPU.REMAT_BACKBONE "auto" recomputes each trainable block in the backward
pass (torch.utils.checkpoint) only for bodies of more than 16 blocks or
with grouped convs: R-50 runs without it.
"""

from collections import namedtuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import Conv2d, FrozenBatchNorm2d, conv_frozen_bn, init_conv_, max_pool2d

StageSpec = namedtuple("StageSpec", ["index", "block_count", "return_features"])


def _spec(counts, returns):
    return tuple(
        StageSpec(index=i + 1, block_count=c, return_features=r)
        for i, (c, r) in enumerate(zip(counts, returns))
    )


STAGE_SPECS = {
    "R-50-FPN": _spec((3, 4, 6, 3), (True, True, True, True)),
    "R-50-FPN-RETINANET": _spec((3, 4, 6, 3), (True, True, True, True)),
    "R-101-FPN": _spec((3, 4, 23, 3), (True, True, True, True)),
    "R-101-FPN-RETINANET": _spec((3, 4, 23, 3), (True, True, True, True)),
    "R-152-FPN": _spec((3, 8, 36, 3), (True, True, True, True)),
}


class Bottleneck(nn.Module):
    def __init__(self, cin, bottleneck, cout, stride, dilation, num_groups,
                 stride_in_1x1):
        super().__init__()
        s1, s2 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = Conv2d(cin, bottleneck, 1, stride=s1, bias=False)
        self.bn1 = FrozenBatchNorm2d(bottleneck)
        self.conv2 = Conv2d(bottleneck, bottleneck, 3, stride=s2,
                            padding=dilation, dilation=dilation,
                            groups=num_groups, bias=False)
        self.bn2 = FrozenBatchNorm2d(bottleneck)
        self.conv3 = Conv2d(bottleneck, cout, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(cout)
        if cin != cout:
            self.downsample = nn.Module()
            self.downsample.conv = Conv2d(cin, cout, 1, stride=stride, bias=False)
            self.downsample.bn = FrozenBatchNorm2d(cout)
        else:
            self.downsample = None

    def reset_parameters(self, gen):
        for conv in (self.conv1, self.conv2, self.conv3):
            init_conv_(conv, gen)
        if self.downsample is not None:
            init_conv_(self.downsample.conv, gen)

    def forward(self, x):
        out = F.relu(conv_frozen_bn(x, self.conv1, self.bn1))
        out = F.relu(conv_frozen_bn(out, self.conv2, self.bn2))
        out = conv_frozen_bn(out, self.conv3, self.bn3)
        if self.downsample is not None:
            identity = conv_frozen_bn(x, self.downsample.conv, self.downsample.bn)
        else:
            identity = x
        return F.relu(out + identity)


class Stem(nn.Module):
    def __init__(self, cout):
        super().__init__()
        self.conv1 = Conv2d(3, cout, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(cout)

    def forward(self, x):
        x = F.relu(conv_frozen_bn(x, self.conv1, self.bn1))
        return max_pool2d(x, window=3, stride=2, padding=1)


class ResNet(nn.Module):
    """Returns the feature maps of the stages whose spec returns them."""

    def __init__(self, cfg):
        super().__init__()
        r = cfg.MODEL.RESNETS
        if r.TRANS_FUNC != "BottleneckWithFixedBatchNorm":
            raise NotImplementedError("ResNet {} is not ported yet".format(r.TRANS_FUNC))
        if any(r.STAGE_WITH_DCN):
            raise NotImplementedError("deformable convs are not ported yet")
        specs = STAGE_SPECS[cfg.MODEL.BACKBONE.CONV_BODY]
        bottleneck2 = r.NUM_GROUPS * r.WIDTH_PER_GROUP
        out2 = r.RES2_OUT_CHANNELS
        self.stem = Stem(r.STEM_OUT_CHANNELS)
        self.stage_names = []
        self.return_features = []
        for spec in specs:
            i = spec.index
            cin = r.STEM_OUT_CHANNELS if i == 1 else out2 * 2 ** (i - 2)
            cout = out2 * 2 ** (i - 1)
            blocks = []
            for k in range(spec.block_count):
                blocks.append(Bottleneck(
                    cin if k == 0 else cout, bottleneck2 * 2 ** (i - 1), cout,
                    stride=(1 if i == 1 else 2) if k == 0 else 1,
                    dilation=r.RES5_DILATION if i == 4 else 1,
                    num_groups=r.NUM_GROUPS, stride_in_1x1=r.STRIDE_IN_1X1,
                ))
            name = "layer{}".format(i)
            setattr(self, name, nn.ModuleList(blocks))
            self.stage_names.append(name)
            self.return_features.append(spec.return_features)
        self.out_channels = [
            out2 * 2 ** (s.index - 1) for s in specs if s.return_features
        ]
        # stage i (1-based) is frozen when FREEZE_CONV_BODY_AT >= i + 1
        freeze_at = cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT
        frozen = ([self.stem] if freeze_at >= 1 else []) + [
            getattr(self, name) for k, name in enumerate(self.stage_names) if freeze_at >= k + 2
        ]
        for module in frozen:
            module.requires_grad_(False)
        self.trainable_stages = [k + 2 > freeze_at for k in range(len(self.stage_names))]
        remat = cfg.TPU.REMAT_BACKBONE
        if remat == "auto":
            self.remat = sum(s.block_count for s in specs) > 16 or r.NUM_GROUPS > 1
        else:
            self.remat = remat in (True, "all", "on")

    def reset_parameters(self, gen):
        init_conv_(self.stem.conv1, gen)
        for name in self.stage_names:
            for block in getattr(self, name):
                block.reset_parameters(gen)

    def forward(self, x):
        x = self.stem(x)
        outputs = []
        for name, ret, trainable in zip(self.stage_names, self.return_features,
                                        self.trainable_stages):
            remat = self.remat and trainable and torch.is_grad_enabled()
            for block in getattr(self, name):
                x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
            if ret:
                outputs.append(x)
        return outputs
