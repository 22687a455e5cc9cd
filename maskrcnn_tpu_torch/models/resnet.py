"""ResNet / ResNeXt body with frozen BN or group norm, and the C4 res5 head.

PyTorch counterpart of maskrcnn_tpu/models/resnet.py. Every frozen BN is
folded into the conv before it (conv_frozen_bn), the same algebra as the
JAX ``conv_norm``; group norm (TRANS_FUNC "BottleneckWithGN", the
gn_baselines files) is not folded: it follows its bias-free conv, as in the
JAX package. The stem is the plain 7x7/stride-2/pad-3 conv: the JAX
package's space-to-depth stem is a TPU rewrite of the same math.

Deformable convs (RESNETS.STAGE_WITH_DCN[i - 1] for layer{i}, the dcn/
files): the block's conv2 becomes a deformable conv v1, or v2 under
WITH_MODULATED_DCN (ops/deform_conv.py), whose offsets (and masks) come
from ``conv2_offset``, a 3x3 conv with a bias, zero at init, run in float32
(2 * 9 offsets a deformable group, then 9 masks through a sigmoid for v2).
Its norm follows it unfolded, as in the JAX package.

The stage tables cover the FPN bodies and the C4/C5 bodies (``ResNet``
returns the maps of the stages whose spec returns them: C5 alone, or C4
alone); ``ResNetHead`` is the C4 models' res5 stage run on pooled ROIs
(JAX ``make_res5_head_config`` / ``apply_res5_head``).

Training: the stem and the first FREEZE_CONV_BODY_AT - 1 stages are frozen
(their parameters do not require grad, so the optimizer skips them; group
norm's affine trains in the other stages, and in the stem too at
FREEZE_CONV_BODY_AT 0), and TPU.REMAT_BACKBONE "auto" recomputes each
trainable block in the backward pass (torch.utils.checkpoint) only for
bodies of more than 16 blocks or with grouped convs: R-50 runs without it.
The res5 head never recomputes, as in the JAX package.

The body's stem and each stage run in a span of their name ("stem",
"layer1", ..., utils/profiling.py:span), as the JAX package names its
scopes; the res5 head has none, as in JAX.
"""

from collections import namedtuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.deform_conv import deform_conv2d
from ..utils.profiling import span
from .layers import (
    Conv2d,
    FrozenBatchNorm2d,
    GroupNorm,
    conv_frozen_bn,
    full_weight,
    init_conv_,
    max_pool2d,
)

StageSpec = namedtuple("StageSpec", ["index", "block_count", "return_features"])


def _spec(counts, returns):
    return tuple(
        StageSpec(index=i + 1, block_count=c, return_features=r)
        for i, (c, r) in enumerate(zip(counts, returns))
    )


STAGE_SPECS = {
    "R-50-C4": _spec((3, 4, 6), (False, False, True)),
    "R-50-C5": _spec((3, 4, 6, 3), (False, False, False, True)),
    "R-101-C4": _spec((3, 4, 23), (False, False, True)),
    "R-101-C5": _spec((3, 4, 23, 3), (False, False, False, True)),
    "R-50-FPN": _spec((3, 4, 6, 3), (True, True, True, True)),
    "R-50-FPN-RETINANET": _spec((3, 4, 6, 3), (True, True, True, True)),
    "R-101-FPN": _spec((3, 4, 23, 3), (True, True, True, True)),
    "R-101-FPN-RETINANET": _spec((3, 4, 23, 3), (True, True, True, True)),
    "R-152-FPN": _spec((3, 8, 36, 3), (True, True, True, True)),
}


NORMS = {"BottleneckWithFixedBatchNorm": "bn", "BottleneckWithGN": "gn"}


def norm_kind(cfg):
    """"bn" (frozen BN) or "gn" (group norm) from RESNETS.TRANS_FUNC, as the
    JAX ``_norm_kind``; the stem follows the same choice."""
    name = cfg.MODEL.RESNETS.TRANS_FUNC
    if name not in NORMS:
        raise NotImplementedError("ResNet {} is not ported yet".format(name))
    return NORMS[name]


def _norm(c, kind, gn_groups):
    return GroupNorm(c, gn_groups) if kind == "gn" else FrozenBatchNorm2d(c)


def conv_norm(x, conv, norm):
    """A bias-free conv and its norm: frozen BN folded into the conv, group
    norm applied after it."""
    if isinstance(norm, GroupNorm):
        return norm(conv(x))
    return conv_frozen_bn(x, conv, norm)


class Bottleneck(nn.Module):
    """dcn: None, or {"modulated": bool, "deformable_groups": int} for a
    deformable conv2."""

    def __init__(self, cin, bottleneck, cout, stride, dilation, num_groups,
                 stride_in_1x1, norm="bn", gn_groups=32, dcn=None):
        super().__init__()
        s1, s2 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = Conv2d(cin, bottleneck, 1, stride=s1, bias=False)
        self.bn1 = _norm(bottleneck, norm, gn_groups)
        self.conv2 = Conv2d(bottleneck, bottleneck, 3, stride=s2,
                            padding=dilation, dilation=dilation,
                            groups=num_groups, bias=False)
        self.bn2 = _norm(bottleneck, norm, gn_groups)
        self.dcn = dcn
        if dcn is not None:
            taps = (27 if dcn["modulated"] else 18) * dcn["deformable_groups"]
            self.conv2_offset = Conv2d(bottleneck, taps, 3, stride=s2, padding=dilation,
                                       dilation=dilation)
        self.conv3 = Conv2d(bottleneck, cout, 1, bias=False)
        self.bn3 = _norm(cout, norm, gn_groups)
        if cin != cout:
            self.downsample = nn.Module()
            self.downsample.conv = Conv2d(cin, cout, 1, stride=stride, bias=False)
            self.downsample.bn = _norm(cout, norm, gn_groups)
        else:
            self.downsample = None

    def reset_parameters(self, gen):
        for conv in (self.conv1, self.conv2, self.conv3):
            init_conv_(conv, gen)
        if self.downsample is not None:
            init_conv_(self.downsample.conv, gen)
        if self.dcn is not None:
            with torch.no_grad():
                self.conv2_offset.weight.zero_()
                self.conv2_offset.bias.zero_()
        for m in self.modules():
            if isinstance(m, GroupNorm):
                m.reset_parameters()

    def deform(self, x):
        """The deformable conv2 and its norm on NCHW x, in x's dtype (its
        whole weight under the model axis, layers.full_weight)."""
        conv, g = self.conv2, self.dcn["deformable_groups"]
        xf = x.float()  # the offset conv's input and the sampled map, one copy
        off = self.conv2_offset(xf).permute(0, 2, 3, 1)
        mask = None
        if self.dcn["modulated"]:
            off, mask = off[..., :18 * g], torch.sigmoid(off[..., 18 * g:])
        out = deform_conv2d(xf.permute(0, 2, 3, 1), off, full_weight(conv), mask,
                            stride=conv.stride[0], padding=conv.padding[0],
                            dilation=conv.dilation[0], groups=conv.groups, deformable_groups=g,
                            compute_dtype=x.dtype)
        return self.bn2(out.permute(0, 3, 1, 2))

    def forward(self, x):
        out = F.relu(conv_norm(x, self.conv1, self.bn1))
        if self.dcn is not None:
            out = F.relu(self.deform(out))
        else:
            out = F.relu(conv_norm(out, self.conv2, self.bn2))
        out = conv_norm(out, self.conv3, self.bn3)
        if self.downsample is not None:
            identity = conv_norm(x, self.downsample.conv, self.downsample.bn)
        else:
            identity = x
        return F.relu(out + identity)


class Stem(nn.Module):
    def __init__(self, cout, norm="bn", gn_groups=32):
        super().__init__()
        self.conv1 = Conv2d(3, cout, 7, stride=2, padding=3, bias=False)
        self.bn1 = _norm(cout, norm, gn_groups)

    def forward(self, x):
        x = F.relu(conv_norm(x, self.conv1, self.bn1))
        return max_pool2d(x, window=3, stride=2, padding=1)


def _stage(cin, bottleneck, cout, count, first_stride, dilation, r, norm, gn_groups, dcn=None):
    return nn.ModuleList([
        Bottleneck(cin if k == 0 else cout, bottleneck, cout,
                   stride=first_stride if k == 0 else 1, dilation=dilation,
                   num_groups=r.NUM_GROUPS, stride_in_1x1=r.STRIDE_IN_1X1,
                   norm=norm, gn_groups=gn_groups, dcn=dcn)
        for k in range(count)])


class ResNet(nn.Module):
    """Returns the feature maps of the stages whose spec returns them."""

    def __init__(self, cfg):
        super().__init__()
        r = cfg.MODEL.RESNETS
        norm = norm_kind(cfg)
        dcn = dict(modulated=r.WITH_MODULATED_DCN, deformable_groups=r.DEFORMABLE_GROUPS)
        with_dcn = tuple(r.STAGE_WITH_DCN)
        specs = STAGE_SPECS[cfg.MODEL.BACKBONE.CONV_BODY]
        bottleneck2 = r.NUM_GROUPS * r.WIDTH_PER_GROUP
        out2 = r.RES2_OUT_CHANNELS
        gn_groups = cfg.MODEL.GROUP_NORM.NUM_GROUPS
        self.stem = Stem(r.STEM_OUT_CHANNELS, norm, gn_groups)
        self.stage_names = []
        self.return_features = []
        for spec in specs:
            i = spec.index
            cin = r.STEM_OUT_CHANNELS if i == 1 else out2 * 2 ** (i - 2)
            name = "layer{}".format(i)
            setattr(self, name, _stage(cin, bottleneck2 * 2 ** (i - 1), out2 * 2 ** (i - 1),
                                       spec.block_count, 1 if i == 1 else 2,
                                       r.RES5_DILATION if i == 4 else 1, r, norm, gn_groups,
                                       dcn if i - 1 < len(with_dcn) and with_dcn[i - 1] else None))
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
        if isinstance(self.stem.bn1, GroupNorm):
            self.stem.bn1.reset_parameters()
        for name in self.stage_names:
            for block in getattr(self, name):
                block.reset_parameters(gen)

    def forward(self, x):
        with span("stem"):
            x = self.stem(x)
        outputs = []
        for name, ret, trainable in zip(self.stage_names, self.return_features,
                                        self.trainable_stages):
            remat = self.remat and trainable and torch.is_grad_enabled()
            with span(name):
                for block in getattr(self, name):
                    x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
            if ret:
                outputs.append(x)
        return outputs


class ResNetHead(nn.Module):
    """The C4 heads' res5 (JAX ``make_res5_head_config`` /
    ``apply_res5_head``): three bottlenecks from RES2_OUT_CHANNELS * 4 to
    * 8 channels, the first at stride 2 unless ROI_BOX_HEAD.DILATION > 1,
    the body's norm, groups and STRIDE_IN_1X1. Takes NCHW ROI features."""

    def __init__(self, cfg):
        super().__init__()
        r = cfg.MODEL.RESNETS
        dilation = cfg.MODEL.ROI_BOX_HEAD.DILATION
        out2 = r.RES2_OUT_CHANNELS
        self.out_channels = out2 * 8
        self.layer4 = _stage(out2 * 4, r.NUM_GROUPS * r.WIDTH_PER_GROUP * 8, out2 * 8, 3,
                             2 if dilation == 1 else 1, dilation, r, norm_kind(cfg),
                             cfg.MODEL.GROUP_NORM.NUM_GROUPS)

    def reset_parameters(self, gen):
        for block in self.layer4:
            block.reset_parameters(gen)

    def forward(self, x):
        for block in self.layer4:
            x = block(x)
        return x
