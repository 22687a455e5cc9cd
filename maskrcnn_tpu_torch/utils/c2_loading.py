"""Detectron (Caffe2 .pkl) and maskrcnn-benchmark (.pth) weight import.

Port of maskrcnn_tpu/utils/c2_loading.py (after the reference
maskrcnn_benchmark/utils/c2_model_loading.py:12-206). Two stages:

  1. blob names -> the reference's torch-style keys, by the same rename
     rules (res2 -> layer1, branch2a -> conv1, bn s/b -> weight/bias,
     fpn_inner{i}, ...), the stage names of the FPN blobs by depth;
  2. torch-style keys -> the port's state_dict names, by the longest
     '.'-suffix match (model_serialization): each of the port's names is
     first given the reference's key by one rename table
     (``torchstyle_key``: downsample.conv/bn -> downsample.0/1,
     fpn.inner.i.conv -> fpn.fpn_inner{i+1}, rpn -> rpn.head, the mask
     head's convs.k.conv -> mask_fcn{k+1}; RetinaNet's towers
     {cls,bbox}_tower.i -> {cls,bbox}_tower.{2i} and P6/P7 top.p6/p7 ->
     fpn.top_blocks.p6/p7; a group norm's scale -> weight, the Xconv
     head's convs.k -> xconvs.{3k}, an FPN group norm as its conv). The
     keypoint head's modules carry the reference's names (conv_fcn1..8,
     kps_score_lowres) and need none, nor does the C4 box head's res5
     (head.layer4.i: Detectron's res5_i blobs end the same way).

The layouts are the reference's and mostly the port's own: conv OIHW,
linear [out, in] and the mask and keypoint heads' transposed convs
[in, out, kh, kw] load as they are (the JAX package flips the last on the
way in and utils/convert.py flips it back). The one change is fc6 after the box
pooler: the reference flattens the pooled [C, P, P] features channel
first, the port (as the JAX package) flattens [P, P, C], so fc6's input
columns are permuted from (C, P, P) to (P, P, C) where C is one of the
backbone widths and P*P a square, as the JAX package infers them.

Detectron's ImageNet files hold frozen BN as an affine pair (``_bn_s``,
``_bn_b``) without running statistics: the port's running mean and
variance then keep their 0 and 1, which gives the same affine.
"""

import logging
import pickle
import re

import numpy as np
import torch

from .model_serialization import align_and_update_state_dicts, strip_prefix_if_present

logger = logging.getLogger(__name__)


# -- stage 1: C2 blob names -> torch-style keys -------------------------------------


def _rename_basic(k):
    k = k.replace("_", ".")
    k = k.replace(".w", ".weight") if k.endswith(".w") else k
    k = k.replace(".bn", "_bn")
    k = k.replace(".b", ".bias") if k.endswith(".b") else k
    k = k.replace("_bn.s", "_bn.scale") if k.endswith("_bn.s") else k
    k = k.replace(".biasranch", ".branch")
    k = k.replace("bbox.pred", "bbox_pred")
    k = k.replace("cls.score", "cls_score")
    k = k.replace("res.conv1_", "conv1_")
    k = k.replace(".biasbox", ".bbox")
    k = k.replace("conv.rpn", "rpn.conv")
    k = k.replace("rpn.bbox.pred", "rpn.bbox_pred")
    k = k.replace("rpn.cls.logits", "rpn.cls_logits")
    k = k.replace("_bn.scale", "_bn.weight")
    k = k.replace("conv1_bn.", "bn1.")
    k = k.replace("res2.", "layer1.")
    k = k.replace("res3.", "layer2.")
    k = k.replace("res4.", "layer3.")
    k = k.replace("res5.", "layer4.")
    k = k.replace(".branch2a.", ".conv1.")
    k = k.replace(".branch2a_bn.", ".bn1.")
    k = k.replace(".branch2b.", ".conv2.")
    k = k.replace(".branch2b_bn.", ".bn2.")
    k = k.replace(".branch2c.", ".conv3.")
    k = k.replace(".branch2c_bn.", ".bn3.")
    k = k.replace(".branch1.", ".downsample.0.")
    k = k.replace(".branch1_bn.", ".downsample.1.")
    # GroupNorm backbones
    k = k.replace("conv1.gn.s", "bn1.weight")
    k = k.replace("conv1.gn.bias", "bn1.bias")
    k = k.replace("conv2.gn.s", "bn2.weight")
    k = k.replace("conv2.gn.bias", "bn2.bias")
    k = k.replace("conv3.gn.s", "bn3.weight")
    k = k.replace("conv3.gn.bias", "bn3.bias")
    k = k.replace("downsample.0.gn.s", "downsample.1.weight")
    k = k.replace("downsample.0.gn.bias", "downsample.1.bias")
    return k


def _rename_fpn(k, stage_names=("1.2", "2.3", "3.5", "4.2")):
    # Detectron FPN blob names carry (stage, last block) pairs; the defaults
    # are R-50's (rename_c2_blobs passes those of the file's depth)
    for mapped_idx, stage in enumerate(stage_names, 1):
        suffix = ".lateral" if mapped_idx < 4 else ""
        k = k.replace("fpn.inner.layer{}.sum{}".format(stage, suffix),
                      "fpn_inner{}".format(mapped_idx))
        k = k.replace("fpn.layer{}.sum".format(stage), "fpn_layer{}".format(mapped_idx))
    k = k.replace("rpn.conv.fpn2", "rpn.conv")
    k = k.replace("rpn.bbox_pred.fpn2", "rpn.bbox_pred")
    k = k.replace("rpn.cls_logits.fpn2", "rpn.cls_logits")
    return k


def _rename_heads(k):
    k = k.replace("mask.fcn.logits", "mask_fcn_logits")
    k = k.replace(".[mask].fcn", "mask_fcn")
    k = k.replace("conv5.mask", "conv5_mask")
    k = k.replace("kps.score.lowres", "kps_score_lowres")
    k = k.replace("kps.score", "kps_score")
    k = k.replace("conv.fcn", "conv_fcn")
    k = re.sub(r"^rpn\.", "rpn.head.", k)
    return k


def rename_c2_blobs(weights, layer3_blocks=6):
    """C2 blob dict -> torch-style-keyed dict of numpy arrays (values
    unchanged); momentum blobs and the solver's scalars are dropped."""
    stage_names = ("1.2", "2.3", {6: "3.5", 23: "3.22", 36: "3.35"}.get(layer3_blocks, "3.5"),
                   "4.2")
    out = {}
    for k in sorted(weights.keys()):
        if "_momentum" in k or k in ("lr", "model_iter", "__preserve__"):
            continue
        nk = {"pred_b": "fc1000_b", "pred_w": "fc1000_w"}.get(k, k)
        nk = _rename_heads(_rename_fpn(_rename_basic(nk), stage_names))
        out[nk] = np.asarray(weights[k])
    return out


# -- stage 2: torch-style keys -> the port's state_dict ------------------------------

# the port's module names where they differ from the reference's
_RENAMES = (
    (r"\.downsample\.conv\.", ".downsample.0."),
    (r"\.downsample\.bn\.", ".downsample.1."),
    (r"\.fpn\.(inner|layer)\.(\d+)\.conv\.",
     lambda m: ".fpn.fpn_{}{}.".format(m[1], int(m[2]) + 1)),
    (r"^rpn\.", "rpn.head."),
    # RetinaNet: the reference's towers are Sequentials of (conv, relu)
    (r"^rpn\.head\.(cls|bbox)_tower\.(\d+)\.",
     lambda m: "rpn.head.{}_tower.{}.".format(m[1], 2 * int(m[2]))),
    (r"^backbone\.top\.", "backbone.fpn.top_blocks."),
    (r"\.mask\.feature_extractor\.convs\.(\d+)\.conv\.",
     lambda m: ".mask.feature_extractor.mask_fcn{}.".format(int(m[1]) + 1)),
    # group norm (the body's norms, the FPN's, the Xconv head's): the JAX
    # rewriter names an FPN conv's norm as the conv itself, fpn_inner{i}
    # (weight and bias), and an Xconv head conv k xconvs.{3k}
    (r"\.box\.feature_extractor\.convs\.(\d+)\.conv\.",
     lambda m: ".box.feature_extractor.xconvs.{}.".format(3 * int(m[1]))),
    (r"\.box\.feature_extractor\.convs\.(\d+)\.gn\.",
     lambda m: ".box.feature_extractor.xconvs.{}.gn.".format(3 * int(m[1]))),
    (r"\.fpn\.(inner|layer)\.(\d+)\.gn\.",
     lambda m: ".fpn.fpn_{}{}.".format(m[1], int(m[2]) + 1)),
    (r"\.scale$", ".weight"),
)


def torchstyle_key(name):
    """The reference's key for the port's state_dict entry `name`
    ("backbone.fpn.inner.0.conv.weight" -> "backbone.fpn.fpn_inner1.weight")."""
    for pattern, repl in _RENAMES:
        name = re.sub(pattern, repl, name)
    return name


def _fc6_permutation(value, c, h, w):
    """fc6 columns from the reference's (C, H, W) flatten to the port's
    (H, W, C)."""
    out_dim = value.shape[0]
    return value.reshape(out_dim, c, h, w).transpose(0, 2, 3, 1).reshape(out_dim, -1)


def _fc6(value):
    res_area = value.shape[1]
    for c in (2048, 1024, 512, 256):
        if res_area % c == 0:
            s = int(round((res_area // c) ** 0.5))
            if s * s == res_area // c:
                return _fc6_permutation(value, c, s, s)
    return value


def _convert(name, template, value):
    """The loaded array in the port's layout, or None when its shape does
    not fit the template's."""
    if name.endswith("fc6.weight") and value.ndim == 2:
        v = _fc6(value)
    elif value.ndim == template.ndim and value.ndim in (2, 4):
        v = value
    else:
        try:
            v = value.reshape(tuple(template.shape))
        except ValueError:
            return None
    return v if tuple(v.shape) == tuple(template.shape) else None


def load_torchstyle_state(state, model_state, cfg=None):
    """Map a torch-style-keyed dict of arrays onto the port's state_dict
    `model_state` (its names and shapes); returns {name: float32 tensor} of
    the entries that loaded. The rest keep the model's values."""
    keys = {name: torchstyle_key(name) for name in model_state}
    match = align_and_update_state_dicts(list(keys.values()), list(state.keys()))
    loaded = {}
    for name, template in model_state.items():
        lk = match.get(keys[name])
        if lk is None:
            continue
        value = np.asarray(state[lk])
        v = _convert(name, template, value)
        if v is None:
            logger.warning("shape mismatch for %s <- %s: %s vs %s", name, lk, value.shape,
                           tuple(template.shape))
            continue
        loaded[name] = torch.tensor(np.ascontiguousarray(v, np.float32))
    logger.info("loaded %d/%d tensors from checkpoint", len(loaded), len(model_state))
    return loaded


def load_c2_weights(path, cfg, model_state):
    """A Detectron .pkl (an ImageNet backbone or a whole detector) as
    {name: tensor} of the port's state_dict entries it holds."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    if "blobs" in data:
        data = data["blobs"]
    # the depth from the blob names (res4_22 present: R-101)
    layer3_blocks = 6
    if any(k.startswith("res4_22") for k in data):
        layer3_blocks = 23
    if any(k.startswith("res4_35") for k in data):
        layer3_blocks = 36
    return load_torchstyle_state(rename_c2_blobs(data, layer3_blocks), model_state, cfg)


def load_pth_weights(path, cfg, model_state):
    """A maskrcnn-benchmark .pth (its state_dict, under "model" or bare,
    "module."-prefixed or not) as {name: tensor} of the port's entries."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in data:
        data = data["model"]
    data = strip_prefix_if_present(data, "module.")
    state = {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
             for k, v in data.items()}
    return load_torchstyle_state(state, model_state, cfg)
