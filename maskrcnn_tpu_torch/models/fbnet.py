"""FBNet mobile bodies and their light heads.

PyTorch counterpart of maskrcnn_tpu/models/fbnet.py, with its own copy of
the plans (plain Python): the five built-in architectures (MODEL_ARCH),
FBNET.ARCH_DEF JSON in either schema (``convert_reference_arch_def``), the
primitive names (``parse_op``), SCALE_FACTOR and WIDTH_DIVISOR. An
architecture is stages of (op, t expansion, c channels, n repeats, s
stride; -2 is a 2x nearest upsample), with stage-index groups for the body
and the RPN, box and mask heads.

Blocks: the inverted residual (``irf``: 1x1 expansion, optionally grouped
with a channel shuffle, kxk depthwise, a second one when cascaded, 1x1
projection, the residual when the shape allows, squeeze-excite after it),
``skip`` (identity, or 1x1 conv + BN + ReLU when the shape changes),
``cascade`` (two 3x3 convs) and ``shift`` (a constant depthwise 5x5 that
moves each channel group). Every BN is frozen and follows its conv
unfolded, as the JAX package's frozen_bn(conv2d(...)); module names are the
JAX tree's (``pw``, ``pw_bn``, ``dw``, ...), so utils/convert.py maps it.
Activations are NCHW (channels_last on the card).

The JAX package reads none of FBNET.DW_CONV_SKIP_BN, DW_CONV_SKIP_RELU,
DET_HEAD_LAST_SCALE, BN_TYPE, RPN_BN_TYPE, *_HEAD_BLOCKS or *_HEAD_STRIDE,
and neither does the port (ROADMAP.md Queue 3). Nothing of the body is
frozen by FREEZE_CONV_BODY_AT: its frozen BNs are buffers, the rest trains.
"""

import decimal
import json

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, FrozenBatchNorm2d, init_conv_, nearest_upsample2x

# [op, t, c, n, s] per block group
MODEL_ARCH = {
    "default": dict(
        first=[32, 2],
        stages=[
            [("k3", 1, 16, 1, 1)],
            [("k3", 6, 24, 2, 2)],
            [("k3", 6, 32, 3, 2)],
            [("k3", 6, 64, 4, 2), ("k3", 6, 96, 3, 1)],
            [("k3", 4, 160, 1, 2), ("k3", 6, 160, 2, 1), ("k3", 6, 240, 1, 1)],
            [("k3", 6, 96, 3, 1)],
            [("k3", 4, 160, 1, 1), ("k3", 6, 160, 3, 1), ("k3", 3, 80, 1, -2)],
        ],
        backbone=[0, 1, 2, 3], rpn=[5], bbox=[4], mask=[6],
    ),
    "mobilenet_v2": dict(
        first=[32, 2],
        stages=[
            [("k3", 1, 16, 1, 1)],
            [("k3", 6, 24, 2, 2)],
            [("k3", 6, 32, 3, 2)],
            [("k3", 6, 64, 4, 2), ("k3", 6, 96, 3, 1)],
            [("k3", 6, 160, 3, 1), ("k3", 6, 320, 1, 1)],
        ],
        backbone=[0, 1, 2, 3], rpn=[], bbox=[4], mask=[],
    ),
    "cham_v1a": dict(
        first=[32, 2],
        stages=[
            [("k3", 1, 24, 1, 1)],
            [("k7", 4, 48, 2, 2)],
            [("k3", 7, 64, 5, 2)],
            [("k5", 12, 56, 7, 2), ("k3", 8, 88, 5, 1)],
            [("k3", 7, 152, 4, 2), ("k3", 10, 104, 1, 1)],
            [("k3", 8, 88, 3, 1)],
        ],
        backbone=[0, 1, 2, 3], rpn=[5], bbox=[4], mask=[],
    ),
    "cham_v2": dict(
        first=[32, 2],
        stages=[
            [("k3", 1, 24, 1, 1)],
            [("k5", 8, 32, 4, 2)],
            [("k7", 5, 48, 6, 2)],
            [("k5", 9, 56, 3, 2), ("k3", 6, 56, 6, 1)],
            [("k3", 2, 160, 6, 2), ("k3", 6, 112, 1, 1)],
            [("k3", 6, 56, 1, 1)],
        ],
        backbone=[0, 1, 2, 3], rpn=[5], bbox=[4], mask=[],
    ),
    "xirb16d_dsmask": dict(
        first=[16, 2],
        stages=[
            [("k3", 1, 16, 1, 1)],
            [("k3", 6, 32, 2, 2)],
            [("k3", 6, 48, 3, 2)],
            [("k3", 6, 96, 4, 2), ("k3", 6, 128, 3, 1)],
            [("k3", 4, 128, 1, 2), ("k3", 6, 128, 2, 1), ("k3", 6, 160, 1, 1)],
            [("k3", 4, 128, 1, 2), ("k3", 6, 128, 2, 1), ("k3", 6, 128, 1, -2),
             ("k3", 3, 64, 1, -2)],
            [("k3", 6, 128, 3, 1)],
        ],
        backbone=[0, 1, 2, 3], rpn=[6], bbox=[4], mask=[5],
    ),
}

_KERNELS = {"k3": 3, "k5": 5, "k7": 7}


def parse_op(name):
    """A primitive's name -> its block spec. ir_k{K}[_e{E}][_s{G}][_se][_sep]
    is the inverted residual: kernel K, expansion override E, grouped
    pointwise convs with a channel shuffle (s2: 2 groups at E = 1, s4: 4 at
    E = 4), squeeze-excite, a cascaded second depthwise (ir_k33 too);
    "shuffle" the residual at 4 groups; "skip", "basic_block" (cascade) and
    "shift_5x5"; k3/k5/k7 stand for ir_k3/5/7."""
    if name in _KERNELS:
        name = "ir_" + name
    if name == "skip":
        return dict(kind="skip")
    if name == "basic_block":
        return dict(kind="cascade")
    if name == "shift_5x5":
        return dict(kind="shift")
    base = dict(kind="irf", kernel=3, pw_group=1, shuffle=False, se=False, cdw=False,
                exp_override=None)
    if name == "shuffle":
        base.update(pw_group=4, shuffle=True)
        return base
    if not name.startswith("ir_k"):
        raise ValueError("unknown FBNet primitive: {}".format(name))
    parts = name[3:].split("_")
    if parts[0] == "k33":
        base.update(kernel=3, cdw=True)
    else:
        base["kernel"] = int(parts[0][1:])
    for p in parts[1:]:
        if p.startswith("e"):
            base["exp_override"] = int(p[1:])
        elif p == "se":
            base["se"] = True
        elif p == "sep":
            base["cdw"] = True
        elif p == "s2":
            base.update(pw_group=2, shuffle=True, exp_override=1)
        elif p == "s4":
            base.update(pw_group=4, shuffle=True, exp_override=4)
        else:
            raise ValueError("unknown FBNet primitive suffix {!r} in {!r}".format(p, name))
    return base


def convert_reference_arch_def(d):
    """An ARCH_DEF of maskrcnn-benchmark's schema (block_op_type, one op a
    block, and block_cfg) -> this module's arch dict."""
    stages = []
    for stage_ops, stage_cfg in zip(d["block_op_type"], d["block_cfg"]["stages"]):
        flat_ops, groups, k = list(stage_ops), [], 0
        for (t, c, n, s) in stage_cfg:
            for i in range(n):
                groups.append((flat_ops[min(k, len(flat_ops) - 1)], t, c, 1, s if i == 0 else 1))
                k += 1
        stages.append(groups)
    cfg = d["block_cfg"]
    out = dict(first=list(cfg["first"]), stages=stages)
    for head in ("backbone", "rpn", "bbox", "mask"):
        if head in cfg:
            out[head] = list(cfg[head])
    if "rpn_stride" in d:
        out["rpn_stride"] = d["rpn_stride"]
    return out


def _py2_round(x):
    return int(decimal.Decimal(x).quantize(decimal.Decimal(1), rounding=decimal.ROUND_HALF_EVEN))


def _divisible(num, divisor):
    if divisor <= 1:
        return int(num)
    return max(divisor, int(num + divisor / 2) // divisor * divisor)


def _scale_channels(c, scale, divisor):
    if scale == 1.0:
        return int(c)
    return _divisible(_py2_round(c * scale), divisor)


def expand_blocks(arch, stage_indices, scale=1.0, divisor=1):
    """The [op, t, c, n, s] groups of the stages -> one spec a block."""
    blocks = []
    for si in stage_indices:
        for (k, t, c, n, s) in arch["stages"][si]:
            c = _scale_channels(c, scale, divisor)
            op = parse_op(k)
            for i in range(n):
                spec = dict(op)
                if spec.pop("exp_override", None) is not None:
                    t = op["exp_override"]
                spec.update(expansion=t, out=c, stride=s if i == 0 else 1)
                blocks.append(spec)
    return blocks


class FBNetPlan:
    """The body's and the heads' block specs of a config."""

    def __init__(self, cfg):
        f = cfg.MODEL.FBNET
        if f.ARCH_DEF:
            arch = json.loads(f.ARCH_DEF)
            if "block_cfg" in arch:
                arch = convert_reference_arch_def(arch)
        else:
            arch = MODEL_ARCH[f.ARCH]
        self.arch = arch
        scale, divisor = f.SCALE_FACTOR, f.WIDTH_DIVISOR
        self.first_out = _scale_channels(arch["first"][0], scale, divisor)
        self.first_stride = arch["first"][1]
        self.trunk_blocks = expand_blocks(arch, arch["backbone"], scale, divisor)
        self.trunk_out = self.trunk_blocks[-1]["out"]
        self.rpn_blocks = expand_blocks(arch, arch.get("rpn", []), scale, divisor)
        self.bbox_blocks = expand_blocks(arch, arch.get("bbox", []), scale, divisor)
        self.mask_blocks = expand_blocks(arch, arch.get("mask", []), scale, divisor)


# -- blocks ---------------------------------------------------------------------


def shift_kernel(c, ksize=5):
    """The Shift op's constant depthwise kernel [c, 1, k, k]: each channel
    group moves to one of the k*k offsets, the centre group taking the
    remainder channels."""
    k = np.zeros((c, 1, ksize, ksize), np.float32)
    ksq, hks, ch = ksize * ksize, ksize // 2, 0
    for i in range(ksize):
        for j in range(ksize):
            num = c // ksq + (c % ksq if (i == hks and j == hks) else 0)
            k[ch:ch + num, 0, i, j] = 1.0
            ch += num
    return torch.from_numpy(k)


def channel_shuffle(x, groups):
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(n, c, h, w)


class SqueezeExcite(nn.Module):
    def __init__(self, c):
        super().__init__()
        mid = max(c // 4, 8)
        self.fc1 = Conv2d(c, mid, 1)
        self.fc2 = Conv2d(mid, c, 1)

    def forward(self, x):
        s = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(s))).float())
        return x * s.to(x.dtype)


class Block(nn.Module):
    """One block of `spec` (parse_op's kind, expansion, out, stride, ...)
    on cin input channels."""

    def __init__(self, cin, spec):
        super().__init__()
        self.spec = spec
        kind, out, stride = spec.get("kind", "irf"), spec["out"], spec["stride"]
        s1 = max(stride, 1)
        self.residual = stride == 1 and cin == out
        if kind == "skip":
            if not self.residual:
                self.conv = Conv2d(cin, out, 1, stride=s1, bias=False)
                self.bn = FrozenBatchNorm2d(out)
        elif kind == "cascade":
            self.conv1 = Conv2d(cin, cin, 3, stride=s1, padding=1, bias=False)
            self.bn1 = FrozenBatchNorm2d(cin)
            self.conv2 = Conv2d(cin, out, 3, padding=1, bias=False)
            self.bn2 = FrozenBatchNorm2d(out)
        elif kind == "shift":
            mid = _divisible(int(cin * spec["expansion"]), 8)
            self.pw = Conv2d(cin, mid, 1, bias=False)
            self.pw_bn = FrozenBatchNorm2d(mid)
            self.register_buffer("shift", shift_kernel(mid), persistent=False)
            self.pwl = Conv2d(mid, out, 1, bias=False)
            self.pwl_bn = FrozenBatchNorm2d(out)
        else:
            mid, g, k = int(cin * spec["expansion"]), spec.get("pw_group", 1), spec["kernel"]
            if spec["expansion"] != 1 or g > 1:
                self.pw = Conv2d(cin, mid, 1, groups=g, bias=False)
                self.pw_bn = FrozenBatchNorm2d(mid)
            if k > 1:
                self.dw = Conv2d(mid, mid, k, stride=s1, padding=k // 2, groups=mid, bias=False)
                self.dw_bn = FrozenBatchNorm2d(mid)
                if spec.get("cdw"):
                    self.dw2 = Conv2d(mid, mid, k, padding=k // 2, groups=mid, bias=False)
                    self.dw2_bn = FrozenBatchNorm2d(mid)
            self.pwl = Conv2d(mid, out, 1, groups=g, bias=False)
            self.pwl_bn = FrozenBatchNorm2d(out)
            if spec.get("se"):
                self.se = SqueezeExcite(out)

    def reset_parameters(self, gen):
        for m in self.modules():
            if isinstance(m, Conv2d):
                init_conv_(m, gen)

    def forward(self, x):
        kind, spec = self.spec.get("kind", "irf"), self.spec
        if kind == "skip":
            return x if self.residual else F.relu(self.bn(self.conv(x)))
        if kind == "cascade":
            out = F.relu(self.bn1(self.conv1(x)))
            out = self.bn2(self.conv2(out))
            return out + x if self.residual else out
        if kind == "shift":
            out = F.relu(self.pw_bn(self.pw(x)))
            out = F.conv2d(out, self.shift.to(out.dtype), None, max(spec["stride"], 1), 2, 1,
                           out.shape[1])
            out = self.pwl_bn(self.pwl(out))
            return out + x if self.residual else out
        out = x
        if hasattr(self, "pw"):
            out = F.relu(self.pw_bn(self.pw(out)))
        g = spec.get("pw_group", 1)
        if spec.get("shuffle") and g > 1:
            out = channel_shuffle(out, g)
        if spec["stride"] == -2:
            out = nearest_upsample2x(out)
        if hasattr(self, "dw"):
            out = F.relu(self.dw_bn(self.dw(out)))
            if hasattr(self, "dw2"):
                out = F.relu(self.dw2_bn(self.dw2(out)))
        out = self.pwl_bn(self.pwl(out))
        if self.residual:
            out = out + x
        if hasattr(self, "se"):
            out = self.se(out)
        return out


class BlockSeq(nn.ModuleList):
    def __init__(self, cin, specs):
        blocks = []
        for spec in specs:
            blocks.append(Block(cin, spec))
            cin = spec["out"]
        super().__init__(blocks)
        self.out_channels = cin

    def reset_parameters(self, gen):
        for block in self:
            block.reset_parameters(gen)

    def forward(self, x):
        for block in self:
            x = block(x)
        return x


# -- body and heads ---------------------------------------------------------------


class FBNetBody(nn.Module):
    """``first`` (3x3 conv + BN + ReLU) and the ``trunk`` blocks."""

    def __init__(self, plan):
        super().__init__()
        self.first = nn.Module()
        self.first.conv = Conv2d(3, plan.first_out, 3, stride=plan.first_stride, padding=1,
                                 bias=False)
        self.first.bn = FrozenBatchNorm2d(plan.first_out)
        self.trunk = BlockSeq(plan.first_out, plan.trunk_blocks)

    def forward(self, x):
        return self.trunk(F.relu(self.first.bn(self.first.conv(x))))


class FBNetBackbone(nn.Module):
    """One map at the body's stride (16 for the built-in architectures)."""

    def __init__(self, cfg):
        super().__init__()
        plan = FBNetPlan(cfg)
        self.body = FBNetBody(plan)
        self.out_channels = plan.trunk_out
        stride = plan.first_stride
        for b in plan.trunk_blocks:
            stride *= 2 if b["stride"] == 2 else 1
        self.strides = [stride]

    def reset_parameters(self, gen):
        init_conv_(self.body.first.conv, gen)
        self.body.trunk.reset_parameters(gen)

    def forward(self, x):
        return [self.body(x)]


class FBNetRPNHead(nn.Module):
    """FBNet.rpn_head: the RPN blocks (``tower``), then 1x1 cls_logits and
    bbox_pred, on each level."""

    def __init__(self, cfg, in_channels, num_anchors):
        super().__init__()
        self.tower = BlockSeq(in_channels, FBNetPlan(cfg).rpn_blocks)
        c = self.tower.out_channels
        self.cls_logits = Conv2d(c, num_anchors, 1)
        self.bbox_pred = Conv2d(c, num_anchors * 4, 1)

    def reset_parameters(self, gen):
        self.tower.reset_parameters(gen)
        for conv in (self.cls_logits, self.bbox_pred):
            init_conv_(conv, gen, init="normal", std=0.01)

    def forward(self, features):
        objectness, bbox_reg = [], []
        for f in features:
            t = self.tower(f)
            objectness.append(self.cls_logits(t))
            bbox_reg.append(self.bbox_pred(t))
        return objectness, bbox_reg


class FBNetROIHead(nn.Module):
    """FBNet.roi_head / FBNet.roi_head_mask: the bbox or mask stages' blocks
    on the pooled ROIs, [R, P, P, C] (NHWC) -> NCHW [R, D, h, w]."""

    def __init__(self, cfg, in_channels, which):
        super().__init__()
        plan = FBNetPlan(cfg)
        self.blocks = BlockSeq(in_channels, {"bbox": plan.bbox_blocks,
                                             "mask": plan.mask_blocks}[which])
        self.out_dim = self.blocks.out_channels

    def reset_parameters(self, gen):
        self.blocks.reset_parameters(gen)

    def forward(self, x):
        return self.blocks(x.permute(0, 3, 1, 2))
