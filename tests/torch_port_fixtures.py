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
    return None if node is None else np.asarray(node)


def numpy_params(jax_model, seed=0):
    params = _redraw(jax.jit(jax_model.init)(jax.random.PRNGKey(seed)), np.random.RandomState(seed))
    pred = params["roi_heads"]["box"]["predictor"]
    rs = np.random.RandomState(seed + 1)
    pred["cls_score"]["w"] = rs.normal(0, 0.3, pred["cls_score"]["w"].shape).astype(np.float32)
    pred["bbox_pred"]["w"] = rs.normal(0, 0.02, pred["bbox_pred"]["w"].shape).astype(np.float32)
    return params


def numpy_tree(jax_model, seed=0):
    """The JAX model's parameter tree drawn in numpy from its shapes
    (jax.eval_shape: nothing is compiled): conv and linear weights normal at
    1 / fan_in, biases N(0, 0.01), frozen BN as numpy_params draws it, the
    FPN's empty slots None."""
    rs = np.random.RandomState(seed)

    def fill(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias", "mean", "var"}:
                return _redraw({k: np.zeros(v.shape, np.float32) for k, v in node.items()}, rs)
            return {k: fill(v) for k, v in node.items()}
        if isinstance(node, list):
            return [fill(v) for v in node]
        if node is None:
            return None
        if len(node.shape) >= 2:
            fan_in = int(np.prod(node.shape[:-1]))
            return rs.normal(0, fan_in ** -0.5, node.shape).astype(np.float32)
        return rs.normal(0, 0.01, node.shape).astype(np.float32)

    return fill(jax.eval_shape(jax_model.init, jax.random.PRNGKey(seed)))


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


def train_batch(seed=0, b=2, h=128, w=160, g=8, mask_size=112):
    """A padded training batch as numpy arrays: uint8 images, image sizes,
    2-6 gt boxes per image (the second image with a padding hole at gt 1),
    labels and binary gt mask patches. The patches are random in 4 x 4
    blocks: a gt box used as a proposal samples each patch at the middle
    between two pixels, and per-pixel noise would put many targets at
    exactly 0.5, where the jitted JAX reference itself flips them with its
    rounding."""
    rs = np.random.RandomState(seed)
    gt = np.zeros((b, g, 4), np.float32)
    labels = np.zeros((b, g), np.int32)
    for i in range(b):
        n = rs.randint(2, min(g, 6) + 1)
        gt[i, :n] = random_boxes(rs, n, 20, min(h, w) - 20, 8, 70)
        labels[i, :n] = rs.randint(1, 81, n)
    labels[-1, 1] = 0
    sizes = np.array([[h, w]] + [[h - 16 * i, w - 24 * i] for i in range(1, b)], np.int32)
    return {
        "images": rs.randint(0, 256, (b, h, w, 3)).astype(np.uint8),
        "image_sizes": sizes,
        "gt_boxes": gt,
        "gt_labels": labels,
        "gt_masks": (rs.rand(b, g, mask_size // 4, mask_size // 4) > 0.5)
        .repeat(4, axis=2).repeat(4, axis=3).astype(np.uint8),
    }


def jax_sampler_draws(rng, b, n_anchors, n_proposals):
    """The uniform draws JAX's train_forward makes from `rng`, split as
    detector.py, rpn.py (rpn_loss), box_head.py (prepare_box_targets) and
    sampler.py (sample_topk_indices) split it, as the port's draws dict."""
    rng_rpn, rng_box = jax.random.split(rng)
    draws = {}
    for kind, key, n in (("rpn", rng_rpn, n_anchors), ("box", rng_box, n_proposals)):
        pos, neg = [], []
        for k in jax.random.split(key, b):
            kp, kn = jax.random.split(k)
            pos.append(np.asarray(jax.random.uniform(kp, (n,))))
            neg.append(np.asarray(jax.random.uniform(kn, (n,))))
        draws[kind + "_pos"], draws[kind + "_neg"] = np.stack(pos), np.stack(neg)
    return draws
