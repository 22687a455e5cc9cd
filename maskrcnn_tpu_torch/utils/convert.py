"""Convert a JAX parameter tree of the JAX package into the port's state_dict.

The JAX package keeps its parameters as nested dicts and lists of arrays:
conv kernels HWIO, linear weights [in, out], frozen BN as {scale, bias,
mean, var}. ``params_from_jax`` walks that tree (given as numpy arrays, so
this module needs no JAX) and returns a flat ``{name: torch.Tensor}`` that
``GeneralizedRCNN.load_state_dict`` takes with ``strict=True``:

  * tree paths become dotted module names (list index = ModuleList index;
    an empty slot, None, as RetinaNet's FPN keeps for C2, is skipped and
    keeps its index, so the FPN over C3-C5 loads into modules 1-3; its
    ``backbone.top`` is P6/P7 and its ``rpn`` the RetinaNet head);
  * leaf ``w``/``b`` become ``weight``/``bias``; BN ``scale``/``mean``/``var``
    become ``weight``/``running_mean``/``running_var``;
  * conv kernels HWIO -> OIHW;
  * the mask head's transposed conv (``conv5_mask``), HWIO with I = input
    channels, -> torch's [in, out, kh, kw] with a spatial flip: the JAX head
    correlates the dilated input with the kernel as stored, torch's
    transposed conv with the kernel flipped (the inverse of the flip in
    maskrcnn_tpu/utils/c2_loading.py);
  * linear weights [in, out] -> [out, in]. The port flattens the pooled
    [R, P, P, C] box features in the same (P, P, C) order as the JAX head,
    so fc6 needs no permutation beyond that transpose.
"""

import numpy as np
import torch

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}
_DECONVS = ("conv5_mask",)


def _walk(node, prefix):
    if isinstance(node, dict):
        if set(node) == set(_BN_LEAVES):
            for k, v in node.items():
                yield prefix + (_BN_LEAVES[k],), v, True
            return
        for k, v in node.items():
            yield from _walk(v, prefix + (str(k),))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _walk(v, prefix + (str(i),))
    elif node is not None:
        yield prefix, node, False


def _leaf_name(path):
    leaf = {"w": "weight", "b": "bias"}.get(path[-1], path[-1])
    return ".".join(path[:-1] + (leaf,))


def _convert(path, value):
    v = np.asarray(value, np.float32)
    if v.ndim == 4:
        if path[-2] in _DECONVS:
            return np.flip(v, axis=(0, 1)).transpose(2, 3, 0, 1)
        return v.transpose(3, 2, 0, 1)
    if v.ndim == 2:
        return v.T
    return v


def params_from_jax(tree):
    """JAX param tree (nested dicts/lists of numpy arrays) -> port state_dict."""
    out = {}
    for path, value, is_bn in _walk(tree, ()):
        name = ".".join(path) if is_bn else _leaf_name(path)
        arr = np.asarray(value, np.float32) if is_bn else _convert(path, value)
        out[name] = torch.tensor(np.ascontiguousarray(arr))
    return out
