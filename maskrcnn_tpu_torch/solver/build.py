"""Optimizer and learning-rate schedule.

PyTorch counterpart of maskrcnn_tpu/solver/build.py (after the reference
solver/build.py and solver/lr_scheduler.py): SGD with momentum and coupled
weight decay, in two parameter groups — biases (parameters whose name ends
in ``.bias``) at BIAS_LR_FACTOR x the learning rate with WEIGHT_DECAY_BIAS,
every other trainable parameter at the base rate with WEIGHT_DECAY. Frozen
parameters (requires_grad False) are left out. The schedule is
WarmupMultiStepLR as a LambdaLR, stepped once after each optimizer step, so
that step k runs at the rate of count k (as optax's schedule count).
"""

import torch


def warmup_multistep_factor(cfg):
    """count -> the factor on the base learning rate: linear or constant
    warmup over WARMUP_ITERS, then GAMMA at each of STEPS."""
    s = cfg.SOLVER
    steps, gamma = tuple(s.STEPS), s.GAMMA
    warmup_iters, warmup_factor, method = s.WARMUP_ITERS, s.WARMUP_FACTOR, s.WARMUP_METHOD
    if method not in ("linear", "constant"):
        raise ValueError("unknown WARMUP_METHOD {}".format(method))

    def factor(count):
        f = 1.0
        if count < warmup_iters:
            if method == "linear":
                alpha = count / max(warmup_iters, 1)
                f = warmup_factor * (1 - alpha) + alpha
            else:
                f = warmup_factor
        for milestone in steps:
            if count >= milestone:
                f *= gamma
        return f

    return factor


def make_optimizer(cfg, model):
    """torch.optim.SGD over the model's trainable parameters, in the weight
    and bias groups."""
    s = cfg.SOLVER
    weights, biases = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (biases if name.endswith(".bias") else weights).append(p)
    groups = [
        {"params": weights, "lr": s.BASE_LR, "weight_decay": s.WEIGHT_DECAY},
        {"params": biases, "lr": s.BASE_LR * s.BIAS_LR_FACTOR,
         "weight_decay": s.WEIGHT_DECAY_BIAS},
    ]
    return torch.optim.SGD(groups, lr=s.BASE_LR, momentum=s.MOMENTUM, nesterov=False)


def make_lr_scheduler(cfg, optimizer):
    return torch.optim.lr_scheduler.LambdaLR(optimizer, warmup_multistep_factor(cfg))
