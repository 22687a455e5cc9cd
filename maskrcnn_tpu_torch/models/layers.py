"""NN primitives of the port: conv, transposed conv, frozen BN, group norm,
linear, pools.

PyTorch counterpart of maskrcnn_tpu/models/layers.py. The JAX package keeps
parameters in float32 and casts them to the compute dtype at each use; the
layers here do the same, casting weights to the dtype of the activation they
meet, so one float32 parameter set serves a float32 model on the CPU and a
bfloat16 model on the card.

Layouts: activations are NCHW tensors, in ``torch.channels_last`` memory
format on the card (physically NHWC, as the JAX package's arrays are). Conv
weights are OIHW, linear weights [out, in]; ``utils/convert.py`` maps the JAX
HWIO / [in, out] layouts onto these.

Initialisers draw from an explicit ``torch.Generator`` with the same
distributions as the JAX ``init_*`` functions (not the same numbers: the two
frameworks' generators differ).
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# -- initialisers ---------------------------------------------------------------


def conv_fans(kh, kw, cin, cout, groups=1):
    return kh * kw * (cin // groups), kh * kw * (cout // groups)


def _normal(shape, std, gen):
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std


def _uniform(shape, bound, gen):
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2 - 1) * bound


def init_conv_(conv, gen, init="msra_fill", std=0.01):
    """Initialise an OIHW conv in place, as layers.init_conv does in JAX:
    "msra_fill" (He-normal, fan_out), "kaiming_uniform" (a=1, fan_in),
    "kaiming_normal_fanin" or "normal"; bias zero."""
    cout, cin_g, kh, kw = conv.weight.shape
    groups = conv.groups
    fan_in, fan_out = conv_fans(kh, kw, cin_g * groups, cout, groups)
    shape = conv.weight.shape
    if init == "msra_fill":
        w = _normal(shape, math.sqrt(2.0 / fan_out), gen)
    elif init == "kaiming_uniform":
        w = _uniform(shape, math.sqrt(3.0 / fan_in), gen)
    elif init == "kaiming_normal_fanin":
        w = _normal(shape, math.sqrt(2.0 / fan_in), gen)
    elif init == "normal":
        w = _normal(shape, std, gen)
    else:
        raise ValueError(init)
    with torch.no_grad():
        conv.weight.copy_(w)
        if conv.bias is not None:
            conv.bias.zero_()


def init_linear_(lin, gen, init="kaiming_uniform", std=0.01):
    cout, cin = lin.weight.shape
    if init == "kaiming_uniform":
        w = _uniform((cout, cin), math.sqrt(3.0 / cin), gen)
    elif init == "normal":
        w = _normal((cout, cin), std, gen)
    else:
        raise ValueError(init)
    with torch.no_grad():
        lin.weight.copy_(w)
        lin.bias.zero_()


# -- modules --------------------------------------------------------------------


class Conv2d(nn.Conv2d):
    """nn.Conv2d that runs in its input's dtype (weights cast at use)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d in its input's dtype. Weight [in, out, kh, kw].

    The JAX head runs lax.conv_transpose on an HWIO kernel without
    transposing it, which correlates the dilated input with the kernel as
    stored; torch's transposed conv flips the kernel spatially. The weight
    converter flips it once (utils/convert.py), so the two agree."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b, self.stride,
                                  self.padding)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class FrozenBatchNorm2d(nn.Module):
    """Frozen BN with NO eps, as the reference FrozenBatchNorm2d and the JAX
    frozen_bn: y = x * scale/sqrt(var) + (bias - mean*scale/sqrt(var))."""

    def __init__(self, c):
        super().__init__()
        self.register_buffer("weight", torch.ones(c))
        self.register_buffer("bias", torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def scale_shift(self):
        s = self.weight * torch.rsqrt(self.running_var)
        return s, self.bias - self.running_mean * s

    def forward(self, x):
        s, t = self.scale_shift()
        return x * s.to(x.dtype)[:, None, None] + t.to(x.dtype)[:, None, None]


def group_norm(x, scale, bias, num_groups, eps=1e-5):
    """Group norm of NCHW x (images, or ROI batches [R, C, P, P]) as the JAX
    package's layers.group_norm computes it: the statistics in float32 over
    (H, W, the channels of a group), the variance in two passes, then the
    affine in float32 and a cast back to x's dtype. Runs on the NHWC view
    (free for channels_last maps, the JAX layout)."""
    n, c, h, w = x.shape
    xf = x.permute(0, 2, 3, 1).float().reshape(n, h, w, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 2, 4), keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    return (xf * scale + bias).to(x.dtype).permute(0, 3, 1, 2)


class GroupNorm(nn.Module):
    """Trainable group norm with the JAX leaf names ``scale`` and ``bias``
    (init 1 and 0). Only MODEL.GROUP_NORM.NUM_GROUPS sets the groups, as in
    the JAX package (DIM_PER_GP is not read)."""

    def __init__(self, c, num_groups):
        super().__init__()
        self.num_groups = num_groups
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def reset_parameters(self):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        return group_norm(x, self.scale, self.bias, self.num_groups)


def conv_frozen_bn(x, conv, bn):
    """conv followed by frozen BN with the affine folded into the conv
    (w * s, bias t), the algebra of resnet.conv_norm in the JAX package."""
    s, t = bn.scale_shift()
    w = conv.weight * s[:, None, None, None]
    return F.conv2d(x, w.to(x.dtype), t.to(x.dtype), conv.stride, conv.padding,
                    conv.dilation, conv.groups)


def max_pool2d(x, window=3, stride=2, padding=1):
    return F.max_pool2d(x, window, stride, padding)


def nearest_upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")
