"""Weights from the seed, made on the device in a few large draws.

A configuration's file lists its initialisers ("init": [pattern, kind,
scale] rows, the first whose regular expression matches a state-dict name
wins), the distributions of the program's own initialisers: "msra" (normal,
std sqrt(2 / fan_out)), "kaiming_uniform" (uniform, bound sqrt(3 /
fan_in)), "kaiming_normal_fanin" (normal, std sqrt(2 / fan_in)), "normal"
(std = scale), "const" (= scale). One standard-normal and one uniform draw
of the whole model's size are cut into the leaves in name order, so the
same seed gives the same weights on every run and for both sides: the
benchmark hands the one state dict to the program and to the reference.
"""

import math
import re

import torch


def _fans(shape, transposed):
    if len(shape) == 4:
        o, i, kh, kw = shape
        if transposed:  # [in, out, kh, kw]
            i, o = o, i
        return i * kh * kw, o * kh * kw
    if len(shape) == 2:
        return shape[1], shape[0]
    return shape[0], shape[0]


def _rule(name, rules):
    for pattern, kind, scale in rules:
        if re.search(pattern, name):
            return kind, scale
    raise KeyError("no initialiser for {} in the configuration's init rules".format(name))


def seeded_state(shapes, rules, seed, device):
    """{name: float32 tensor} for shapes {name: shape}, drawn on `device`
    from a torch.Generator seeded with `seed`."""
    plan, n_normal, n_uniform = [], 0, 0
    for name in sorted(shapes):
        shape = tuple(shapes[name])
        kind, scale = _rule(name, rules)
        numel = math.prod(shape)
        fan_in, fan_out = _fans(shape, "conv5_mask" in name)
        if kind == "msra":
            plan.append((name, shape, "n", n_normal, math.sqrt(2.0 / fan_out)))
            n_normal += numel
        elif kind == "kaiming_normal_fanin":
            plan.append((name, shape, "n", n_normal, math.sqrt(2.0 / fan_in)))
            n_normal += numel
        elif kind == "normal":
            plan.append((name, shape, "n", n_normal, float(scale)))
            n_normal += numel
        elif kind == "kaiming_uniform":
            plan.append((name, shape, "u", n_uniform, math.sqrt(3.0 / fan_in)))
            n_uniform += numel
        elif kind == "const":
            plan.append((name, shape, "c", 0, float(scale)))
        else:
            raise ValueError("unknown initialiser {} for {}".format(kind, name))
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device) * 2 - 1
    out = {}
    for name, shape, src, off, scale in plan:
        numel = math.prod(shape)
        if src == "c":
            out[name] = torch.full(shape, scale, device=device)
        else:
            base = normal if src == "n" else uniform
            out[name] = base[off:off + numel].reshape(shape) * scale
    return out
