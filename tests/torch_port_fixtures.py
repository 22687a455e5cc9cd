"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_*.py).

A narrow Mask R-CNN R-50-FPN (the flagship configuration at a few widths
small enough for the CPU), built once in JAX and once in the port from the
same parameters: the JAX ``model.init`` tree, with the frozen-BN statistics
and the box predictor redrawn from a numpy seed so that activations stay
bounded and the class scores spread over several classes, passed to the
port through ``params_from_jax``.
"""

import numpy as np

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship_cfg
from maskrcnn_tpu.models import build_detection_model as build_jax_model
from maskrcnn_tpu_torch.config import flagship_cfg
from maskrcnn_tpu_torch.models import build_detection_model as build_torch_model
from maskrcnn_tpu_torch.utils.convert import params_from_jax


def narrow(c):
    """Shrink a flagship config to CPU-test widths (float32 compute)."""
    c.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
    c.MODEL.RESNETS.STEM_OUT_CHANNELS = 16
    c.MODEL.RESNETS.WIDTH_PER_GROUP = 16
    c.MODEL.RESNETS.BACKBONE_OUT_CHANNELS = 32
    c.MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM = 64
    c.MODEL.ROI_MASK_HEAD.CONV_LAYERS = (32,) * 4
    c.TPU.COMPUTE_DTYPE = "float32"
    c.INPUT.PIXEL_STD = [57.375, 57.12, 58.395]
    c.MODEL.ROI_HEADS.SCORE_THRESH = 0.01
    return c


def configs():
    return narrow(_flagship_cfg(tiny=True)), narrow(flagship_cfg(tiny=True))


def _redraw(node, rs):
    if isinstance(node, dict):
        if set(node) == {"scale", "bias", "mean", "var"}:
            c = node["scale"].shape[0]
            return {
                "scale": rs.uniform(0.3, 0.7, c).astype(np.float32),
                "bias": rs.uniform(-0.1, 0.1, c).astype(np.float32),
                "mean": rs.uniform(-0.1, 0.1, c).astype(np.float32),
                "var": rs.uniform(0.5, 1.5, c).astype(np.float32),
            }
        return {k: _redraw(v, rs) for k, v in node.items()}
    if isinstance(node, list):
        return [_redraw(v, rs) for v in node]
    return np.asarray(node)


def numpy_params(jax_model, seed=0):
    params = _redraw(jax.jit(jax_model.init)(jax.random.PRNGKey(seed)), np.random.RandomState(seed))
    pred = params["roi_heads"]["box"]["predictor"]
    rs = np.random.RandomState(seed + 1)
    pred["cls_score"]["w"] = rs.normal(0, 0.3, pred["cls_score"]["w"].shape).astype(np.float32)
    pred["bbox_pred"]["w"] = rs.normal(0, 0.02, pred["bbox_pred"]["w"].shape).astype(np.float32)
    return params


def model_pair(seed=0):
    """(jax_model, jax params as jnp arrays, the port's model on the CPU)."""
    jcfg, tcfg = configs()
    jm = build_jax_model(jcfg)
    params = numpy_params(jm, seed)
    tm = build_torch_model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(params), strict=True)
    return jm, jax.tree.map(jnp.asarray, params), tm


def random_boxes(rs, n, lo, hi, min_wh, max_wh):
    ctr = rs.uniform(lo, hi, (n, 2))
    wh = rs.uniform(min_wh, max_wh, (n, 2))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
