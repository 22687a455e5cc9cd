"""The reference GN Mask R-CNN R-50-FPN with the Xconv1fc box head.

maskrcnn-benchmark's configs/gn_baselines/e2e_mask_rcnn_R_50_FPN_Xconv1fc_1x_gn.yaml,
the Detectron GN baseline of Wu & He, "Group Normalization" (ECCV 2018,
arXiv:1803.08494): reference/model.py's Mask R-CNN R-50-FPN with a group
norm (MODEL.GROUP_NORM.NUM_GROUPS groups, EPSILON) in place of every frozen
BN and after every conv of the FPN and of both heads:

* the stem and every bottleneck (StemWithGN, BottleneckWithGN): each conv
  without a bias, then its group norm; the stride in the 3x3 conv
  (STRIDE_IN_1X1 False), model.py's blocks with their norms replaced;
* every FPN conv (FPN.USE_GN): no bias, then a group norm;
* the box head, FPNXconv1fcFeatureExtractor: NUM_STACKED_CONVS 3x3 convs of
  CONV_HEAD_DIM, each without a bias, with a group norm and a ReLU, then fc6
  and a ReLU; model.py's predictor;
* the mask head (ROI_MASK_HEAD.USE_GN, make_conv3x3(use_gn=True)): each of
  its 3x3 convs without a bias, then a group norm, then its ReLU; model.py's
  deconv and 1x1 logits.

Departure from the published model, in the layout only: fc6 takes the
pooled features flattened (P, P, C), as the program's, where
maskrcnn-benchmark flattens (C, P, P) (a permutation of fc6's columns).
Module and parameter names are the program's (a group norm's leaves
``scale`` and ``bias``), so one state dict loads into both.

The group norm is written from its definition: x.view(N, G, -1), the mean
and the biased variance over each group, (x - mean) / sqrt(var + eps), then
the per-channel affine. It computes in float32, with TF32 off in every pass
(``float32_products``), and imports nothing of the program and no JAX.
Under autograd each group norm keeps only its input and recomputes the
rest in the backward pass (torch.utils.checkpoint, the same arithmetic, so
the gradients are those of the plain graph), so that a float32 step at
batch 16 holds one float32 copy of each normalised map, not the three or
four that its centred, normalised and affine tensors would keep.
``set_precision(model, "fp8")`` rounds as model.py's does, a group norm's
output too, which the program stores in bf16.

The model has no frozen BN, so ``calibrate`` sets nothing. The harness
reaches the module by name (configs/<config>.json "reference":
"mask_rcnn_gn") through harness/spec.py's REFERENCE_API, and
tools/readings.py through its TOOL_API.
"""

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import model as ref
from . import ops  # noqa: F401  (TOOL_API: the pooler fault wraps ops.roi_align)
from .model import Conv2d, Linear, _Rounded, box_head_inference, select_proposals  # noqa: F401
from .model import set_precision, training_proposals  # noqa: F401


class float32_products:
    """TF32 off for the convolutions and matrix products inside, restored
    after (a context manager and a decorator)."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved

    def __call__(self, f):
        @functools.wraps(f)
        def run(*args, **kwargs):
            with float32_products():
                return f(*args, **kwargs)
        return run


def group_norm(x, scale, bias, groups, eps):
    """Group norm of NCHW x from its definition: over each image's groups of
    C / groups channels and all their pixels, the mean and the biased
    variance, (x - mean) / sqrt(var + eps), then scale and bias a channel."""
    g = x.reshape(x.shape[0], groups, -1)
    mean = g.mean(dim=-1, keepdim=True)
    var = ((g - mean) ** 2).mean(dim=-1, keepdim=True)
    y = ((g - mean) / torch.sqrt(var + eps)).reshape(x.shape)
    return y * scale[None, :, None, None] + bias[None, :, None, None]


class GroupNorm(_Rounded, nn.Module):
    def __init__(self, c, groups, eps):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        args = (x, self.scale, self.bias, self.groups, self.eps)
        if torch.is_grad_enabled() and (x.requires_grad or self.scale.requires_grad):
            return self._q(checkpoint(group_norm, *args, use_reentrant=False))
        return self._q(group_norm(*args))


def conv_gn(x, conv, gn):
    """A bias-free conv and its group norm (the `norm` of model.py's
    ResNet and Bottleneck)."""
    return gn(conv(x))


def _gn(cfg, c):
    g = cfg["MODEL"]["GROUP_NORM"]
    return GroupNorm(c, g["NUM_GROUPS"], g["EPSILON"])


class ResNet(ref.ResNet):
    """model.py's ResNet (its stages, stride and freezing) with a group norm
    in place of each frozen BN."""

    def __init__(self, cfg):
        super().__init__(cfg)
        frozen = [m for m in [self.stem] + [getattr(self, n) for n in self.stage_names]
                  if not any(p.requires_grad for p in m.parameters())]
        for module in list(self.modules()):
            for name, child in list(module.named_children()):
                if isinstance(child, ref.FrozenBatchNorm2d):
                    setattr(module, name, _gn(cfg, child.weight.shape[0]))
        for module in frozen:
            module.requires_grad_(False)

    def forward(self, x):
        return super().forward(x, norm=conv_gn)


class _ConvGN(nn.Module):
    def __init__(self, cfg, cin, cout, k):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, padding=k // 2, bias=False)
        self.gn = _gn(cfg, cout)

    def forward(self, x):
        return self.gn(self.conv(x))


class FPN(ref.FPN):
    """model.py's FPN (top-down sums, P6 as P5's stride-2 subsample), each
    conv without a bias and with a group norm."""

    def __init__(self, cfg, in_channels_list, out_channels):
        nn.Module.__init__(self)
        self.inner = nn.ModuleList([_ConvGN(cfg, c, out_channels, 1) for c in in_channels_list])
        self.layer = nn.ModuleList([_ConvGN(cfg, out_channels, out_channels, 3)
                                    for _ in in_channels_list])


class Backbone(ref.Backbone):
    def __init__(self, cfg):
        nn.Module.__init__(self)
        self.body = ResNet(cfg)
        self.out_channels = cfg["MODEL"]["RESNETS"]["BACKBONE_OUT_CHANNELS"]
        out2 = cfg["MODEL"]["RESNETS"]["RES2_OUT_CHANNELS"]
        self.fpn = FPN(cfg, [out2, out2 * 2, out2 * 4, out2 * 8], self.out_channels)


class XconvBoxHead(nn.Module):
    """FPNXconv1fcFeatureExtractor with group norm, and model.py's
    predictor."""

    predict = ref.BoxHead.predict

    def __init__(self, cfg, c):
        super().__init__()
        h = cfg["MODEL"]["ROI_BOX_HEAD"]
        fe = self.feature_extractor = nn.Module()
        fe.convs = nn.ModuleList()
        for _ in range(h["NUM_STACKED_CONVS"]):
            fe.convs.append(_ConvGN(cfg, c, h["CONV_HEAD_DIM"], 3))
            c = h["CONV_HEAD_DIM"]
        fe.fc6 = Linear(c * h["POOLER_RESOLUTION"] ** 2, h["MLP_HEAD_DIM"])
        self.res5 = False
        self.out_dim = h["MLP_HEAD_DIM"]
        self.predictor = nn.Module()
        self.predictor.cls_score = Linear(self.out_dim, h["NUM_CLASSES"])
        self.predictor.bbox_pred = Linear(self.out_dim, h["NUM_CLASSES"] * 4)

    def extract(self, pooled):
        """[R, P, P, C] -> [R, MLP_HEAD_DIM]."""
        x = pooled.permute(0, 3, 1, 2)
        for block in self.feature_extractor.convs:
            x = F.relu(block(x))
        return F.relu(self.feature_extractor.fc6(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)))


class MaskHead(ref.MaskHead):
    """model.py's FPN mask head, each conv without a bias and with a group
    norm before its ReLU."""

    def __init__(self, cfg, c):
        super().__init__(cfg, c)
        h = cfg["MODEL"]["ROI_MASK_HEAD"]
        cin = c
        for i, cout in enumerate(h["CONV_LAYERS"]):
            self.feature_extractor.convs[i] = _ConvGN(cfg, cin, cout, 3)
            cin = cout

    def _upsampled(self, x):
        x = x.permute(0, 3, 1, 2)
        for block in self.feature_extractor.convs:
            x = F.relu(block(x))
        return F.relu(self.predictor.conv5_mask(x))


# what this reference models; any other value is another model
MODELED = {("MODEL", "BACKBONE", "CONV_BODY"): "R-50-FPN",
           ("MODEL", "RESNETS", "TRANS_FUNC"): "BottleneckWithGN",
           ("MODEL", "RESNETS", "STEM_FUNC"): "StemWithGN",
           ("MODEL", "FPN", "USE_GN"): True,
           ("MODEL", "FPN", "USE_RELU"): False,
           ("MODEL", "ROI_BOX_HEAD", "FEATURE_EXTRACTOR"): "FPNXconv1fcFeatureExtractor",
           ("MODEL", "ROI_BOX_HEAD", "USE_GN"): True,
           ("MODEL", "ROI_MASK_HEAD", "FEATURE_EXTRACTOR"): "MaskRCNNFPNFeatureExtractor",
           ("MODEL", "ROI_MASK_HEAD", "USE_GN"): True,
           ("MODEL", "ROI_MASK_HEAD", "DILATION"): 1,
           ("MODEL", "ROI_MASK_HEAD", "SHARE_BOX_FEATURE_EXTRACTOR"): False}


def _at(cfg, path):
    for key in path:
        cfg = cfg[key]
    return cfg


class MaskRCNN(ref.MaskRCNN):
    """cfg: the configuration as nested dicts. model.py's detector (RPN,
    proposals, targets, losses, post-process) around the GN backbone and
    heads. Float32; every pass with TF32 off."""

    def __init__(self, cfg):
        other = {path: _at(cfg, path) for path, want in MODELED.items() if _at(cfg, path) != want}
        if other:
            raise NotImplementedError("the GN reference does not model {}".format(other))
        # model.py builds the FPN2MLP box head it knows; every part this
        # model changes is replaced below
        super().__init__(dict(cfg, MODEL=dict(cfg["MODEL"], ROI_BOX_HEAD=dict(
            cfg["MODEL"]["ROI_BOX_HEAD"], FEATURE_EXTRACTOR="FPN2MLPFeatureExtractor"))))
        self.cfg = cfg
        self.backbone = Backbone(cfg)
        c = self.backbone.out_channels
        self.roi_heads.box = XconvBoxHead(cfg, c)
        self.roi_heads.mask = MaskHead(cfg, c)

    train_forward = float32_products()(ref.MaskRCNN.train_forward)
    infer_forward = float32_products()(ref.MaskRCNN.infer_forward)
    judge = float32_products()(ref.MaskRCNN.judge)


def calibrate(model, batch):
    """Nothing to set: the model has no frozen BN (group norm normalises
    every batch itself)."""
