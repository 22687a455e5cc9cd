"""NN primitives of the port: conv, transposed conv, frozen BN, linear, pools.

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
