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

Under the mesh's "model" axis (parallel/mesh.py:shard_model) a conv's,
transposed conv's or fc's weight may hold only this process's block of its
output channels. The layer gathers the whole weight at use (``full_weight``:
the blocks cast to the input's dtype, then gathered over the model group;
backward, this process's slice of the gradient) and computes what the
unsharded layer computes, op for op. ``out_channels`` and the other
attributes keep the full widths.
"""

import ctypes
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import native
from ..utils import comm
from ..utils.profiling import span

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


def full_weight(module, w=None):
    """`w` (by default the module's weight; else a tensor computed from it
    element by element, at its layout, such as its cast) whole: when the
    weight is sharded on the model axis, the model group's blocks of `w`
    gathered (comm.gather_from_model), else `w` itself."""
    w = module.weight if w is None else w
    dim = getattr(module.weight, "model_dim", None)
    return w if dim is None else comm.gather_from_model(w, dim)


class Conv2d(nn.Conv2d):
    """nn.Conv2d that runs in its input's dtype (weights cast at use)."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, full_weight(self, self.weight.to(x.dtype)), b, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d in its input's dtype. Weight [in, out, kh, kw].

    The JAX head runs lax.conv_transpose on an HWIO kernel without
    transposing it, which correlates the dilated input with the kernel as
    stored; torch's transposed conv flips the kernel spatially. The weight
    converter flips it once (utils/convert.py), so the two agree."""

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, full_weight(self, self.weight.to(x.dtype)), b,
                                  self.stride, self.padding)


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, full_weight(self, self.weight.to(x.dtype)), self.bias.to(x.dtype))


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


def group_norm_plain(x, scale, bias, num_groups, eps=1e-5):
    """Group norm of NCHW x (images, or ROI batches [R, C, P, P]) as the JAX
    package's layers.group_norm computes it: the statistics in float32 (in
    x's dtype where that is wider) over (H, W, the channels of a group), the
    variance in two passes, then the affine in float32 and a cast back to x's
    dtype. Runs on the NHWC view (free for channels_last maps, the JAX
    layout). CPU tensors take it (``group_norm``); the card's kernels
    compute the same."""
    n, c, h, w = x.shape
    xf = x.permute(0, 2, 3, 1).to(torch.promote_types(x.dtype, torch.float32))
    xf = xf.reshape(n, h, w, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 2, 4), keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    return (xf * scale + bias).to(x.dtype).permute(0, 3, 1, 2)


_I, _P, _L = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
_GN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _gn_lib():
    lib = native.load("group_norm")
    if not getattr(lib, "_typed", False):
        lib.group_norm_plan.argtypes = [_I, _I, _I, _I, _I, _I, ctypes.POINTER(_L)]
        lib.group_norm_forward.argtypes = [_P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _P,
                                           _P, _P, _P, _L, _P]
        lib.group_norm_backward.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                                            _P, _L, _P]
        for fn in (lib.group_norm_plan, lib.group_norm_forward, lib.group_norm_backward):
            fn.restype = _I
        lib._typed = True
    return lib


def group_norm_path(x, num_groups, backward=False):
    """(path, float32 workspace) of the kernels at x's shape, dtype and
    direction: "sample" (a sample staged in one block's shared memory) or
    "spans" (each sample cut into pixel spans). Raises ValueError for a
    shape the kernels do not take (C % 8, C > 2048, C % groups)."""
    n, c, h, w = x.shape
    ws = _L()
    path = _gn_lib().group_norm_plan(n, h * w, c, num_groups, _GN_DTYPES[x.dtype],
                                     int(backward), ctypes.byref(ws))
    if path < 0:
        raise ValueError("group_norm kernel takes C % 8 == 0, C <= 2048 and C % groups == 0, "
                         "not C={} in {} groups".format(c, num_groups))
    return ("spans", "sample")[path], torch.empty(ws.value, dtype=torch.float32,
                                                  device=x.device)


def _check_maps(what, x, *tensors):
    for t in (x, *tensors):
        if t.device != x.device or t.dtype != x.dtype or t.shape != x.shape:
            raise ValueError("{}: tensors differ in device, dtype or shape".format(what))
        if not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("{} kernel takes channels_last-contiguous NCHW maps".format(what))
        if t.data_ptr() % 16:
            raise ValueError("{} kernel takes 16-byte aligned maps".format(what))


class GroupNormFunction(torch.autograd.Function):
    """csrc/group_norm.cu's forward, with its backward as the gradient.
    Saves x (in its dtype) and the per-(n, group) mean and rstd (float32);
    the scale and bias get float32 gradients."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps):
        n, c, h, w = x.shape
        y = torch.empty_like(x, memory_format=torch.channels_last)
        stats = torch.empty((2, n, num_groups), dtype=torch.float32, device=x.device)
        if x.numel():
            _, ws = group_norm_path(x, num_groups)
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = _gn_lib().group_norm_forward(
                x.data_ptr(), scale.data_ptr(), bias.data_ptr(), n, h * w, c, num_groups, eps,
                _GN_DTYPES[x.dtype], y.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
                ws.data_ptr(), ws.numel(), stream)
            native.check(rc, "group_norm")
            _COUNTERS.launches += 1
        ctx.num_groups = num_groups
        ctx.save_for_backward(x, scale, stats)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, stats = ctx.saved_tensors
        with span("group_norm.bwd"):
            _check_maps("group_norm backward", x, dy)
            n, c, h, w = x.shape
            dx = torch.empty_like(x, memory_format=torch.channels_last)
            dscale, dbias = torch.empty_like(scale), torch.empty_like(scale)
            if not x.numel():
                dscale.zero_()
                dbias.zero_()
            else:
                _, ws = group_norm_path(x, ctx.num_groups, backward=True)
                stream = torch.cuda.current_stream(x.device).cuda_stream
                rc = _gn_lib().group_norm_backward(
                    x.data_ptr(), dy.data_ptr(), scale.data_ptr(), stats[0].data_ptr(),
                    stats[1].data_ptr(), n, h * w, c, ctx.num_groups, _GN_DTYPES[x.dtype],
                    dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), ws.data_ptr(),
                    ws.numel(), stream)
                native.check(rc, "group_norm backward")
                _COUNTERS.bwd_launches += 1
        return dx, dscale, dbias, None, None


def group_norm(x, scale, bias, num_groups, eps=1e-5):
    """Group norm of NCHW x (images, or ROI batches [R, C, P, P]), the JAX
    package's layers.group_norm, in a span "group_norm". CPU tensors take
    ``group_norm_plain`` (its backward nodes join the span by sequence
    number). CUDA tensors take the kernels of csrc/group_norm.cu through
    ``GroupNormFunction`` (its backward in a span "group_norm.bwd"), or
    raise: x float32 or bfloat16, channels_last-contiguous, 16-byte aligned;
    scale and bias float32 [C]; y channels_last in x's dtype."""
    with span("group_norm"):
        if x.device.type == "cpu":
            return group_norm_plain(x, scale, bias, num_groups, eps)
        if x.device.type != "cuda":
            raise ValueError("group_norm runs on cpu or cuda tensors, not {}".format(x.device))
        if x.dtype not in _GN_DTYPES:
            raise TypeError("group_norm kernel takes float32 or bfloat16 maps")
        _check_maps("group_norm", x)
        for t in (scale, bias):
            if (t.device != x.device or t.dtype != torch.float32 or t.shape != (x.shape[1],)
                    or not t.is_contiguous()):
                raise ValueError("group_norm kernel takes float32 [C] scale and bias")
        return GroupNormFunction.apply(x, scale, bias, num_groups, eps)


group_norm.launches = 0      # forward calls that launched the kernels
group_norm.bwd_launches = 0  # backward calls that launched them
# the counters' owner, whatever later stands in for the module's name
# (utils/profiling.py:function_shares wraps it while it profiles)
_COUNTERS = group_norm


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


class ConvBlock(nn.Module):
    """A k x k conv under the JAX tree's names ("conv", "gn"): with a bias,
    or (gn_groups > 0) without one and a group norm after it; then a ReLU
    when asked for. The FPN's convs and the Xconv box head's and the mask
    head's (maskrcnn-benchmark's make_conv3x3)."""

    def __init__(self, cin, cout, k, gn_groups=0, relu=False, dilation=1,
                 init="kaiming_uniform"):
        super().__init__()
        self.conv = Conv2d(cin, cout, k, padding=dilation * (k // 2), dilation=dilation,
                           bias=not gn_groups)
        self.gn = GroupNorm(cout, gn_groups) if gn_groups else None
        self.relu, self.init = relu, init

    def reset_parameters(self, gen):
        init_conv_(self.conv, gen, init=self.init)
        if self.gn is not None:
            self.gn.reset_parameters()

    def forward(self, x):
        x = self.conv(x)
        if self.gn is not None:
            x = self.gn(x)
        return F.relu(x) if self.relu else x


def conv_frozen_bn(x, conv, bn):
    """conv followed by frozen BN with the affine folded into the conv
    (w * s, bias t), the algebra of resnet.conv_norm in the JAX package; a
    weight sharded on the model axis folds s's block into its own, then is
    gathered."""
    s, t = bn.scale_shift()
    if getattr(conv.weight, "model_dim", None) is not None:
        s = comm.model_block(s, 0)
    w = full_weight(conv, (conv.weight * s[:, None, None, None]).to(x.dtype))
    return F.conv2d(x, w, t.to(x.dtype), conv.stride, conv.padding, conv.dilation, conv.groups)


def max_pool2d(x, window=3, stride=2, padding=1):
    return F.max_pool2d(x, window, stride, padding)


def nearest_upsample2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")
