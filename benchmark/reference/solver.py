"""The reference's solver and the frozen-BN calibration.

``make_sgd`` is a copy of the program's solver/build.py (SGD with momentum
and coupled weight decay in a weight and a bias group, the warm-up
multi-step schedule). ``calibrate_frozen_bn`` is a copy of chip_smoke.py's:
every frozen BN of the body is set, layer by layer, from one batch (the
running mean and variance + 1e-5 of the conv output it follows, weight 1,
bias 0), since random weights with identity BN grow activations to ~1e4.
"""

import torch
import torch.nn.functional as F

from . import model as ref


def warmup_factor(solver):
    steps, gamma = tuple(solver["STEPS"]), solver["GAMMA"]
    iters, factor0, method = solver["WARMUP_ITERS"], solver["WARMUP_FACTOR"], solver["WARMUP_METHOD"]

    def factor(count):
        f = 1.0
        if count < iters:
            if method == "linear":
                alpha = count / max(iters, 1)
                f = factor0 * (1 - alpha) + alpha
            else:
                f = factor0
        for milestone in steps:
            if count >= milestone:
                f *= gamma
        return f

    return factor


def make_sgd(solver, model):
    """(optimizer, scheduler) over the trainable parameters."""
    weights, biases = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (biases if name.endswith(".bias") else weights).append(p)
    opt = torch.optim.SGD([
        {"params": weights, "lr": solver["BASE_LR"], "weight_decay": solver["WEIGHT_DECAY"]},
        {"params": biases, "lr": solver["BASE_LR"] * solver["BIAS_LR_FACTOR"],
         "weight_decay": solver["WEIGHT_DECAY_BIAS"]},
    ], lr=solver["BASE_LR"], momentum=solver["MOMENTUM"], nesterov=False)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, warmup_factor(solver))


@torch.no_grad()
def calibrate_frozen_bn(model, batch):
    """Set the body's frozen BNs from `batch` (see the module's docstring)."""

    def calibrating(x, conv, bn):
        y = F.conv2d(x, conv.weight, None, conv.stride, conv.padding, conv.dilation, conv.groups)
        bn.weight.fill_(1.0)
        bn.bias.zero_()
        bn.running_mean.copy_(y.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(y.var(dim=(0, 2, 3)) + 1e-5)
        return ref.conv_frozen_bn(x, conv, bn)

    x = model.normalize(batch["images"], batch["image_sizes"]).permute(0, 3, 1, 2).contiguous()
    model.backbone.body(x, norm=calibrating)
