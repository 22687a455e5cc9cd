"""ImageList: a padded batch of images and the true size of each.

Port of maskrcnn_tpu/structures/image_list.py (after the reference
maskrcnn_benchmark/structures/image_list.py). The layout is the JAX
package's NHWC, the one the port's models take. ``to_image_list`` pads a
list of [H, W, C] images (numpy arrays or torch tensors, kept as given)
with zeros at the bottom and right to the batch's largest height and width,
each rounded up to ``size_divisible``, or to a fixed ``target_shape``.
"""

import math

import numpy as np
import torch


class ImageList:
    def __init__(self, tensors, image_sizes):
        """tensors: [B, H, W, C]; image_sizes: one (h, w) per image."""
        self.tensors = tensors
        self.image_sizes = [tuple(int(v) for v in s) for s in image_sizes]

    def to(self, *args, **kwargs):
        if isinstance(self.tensors, torch.Tensor):
            return ImageList(self.tensors.to(*args, **kwargs), self.image_sizes)
        return self

    def __len__(self):
        return self.tensors.shape[0]


def to_image_list(tensors, size_divisible=0, target_shape=None):
    """One [B, Hp, Wp, C] batch of the [H, W, C] images `tensors`: Hp and Wp
    are the batch's largest, rounded up to `size_divisible` when it is
    positive, or `target_shape` (h, w), which must hold them (ValueError).
    A [B, H, W, C] batch is taken as it is."""
    if isinstance(tensors, ImageList):
        return tensors
    if tensors.__class__ in (np.ndarray, torch.Tensor) and tensors.ndim == 3:
        tensors = [tensors]
    if tensors.__class__ in (np.ndarray, torch.Tensor) and tensors.ndim == 4:
        return ImageList(tensors, [t.shape[:2] for t in tensors])
    if not isinstance(tensors, (list, tuple)):
        raise TypeError("to_image_list takes images, got {}".format(type(tensors)))
    max_h = max(t.shape[0] for t in tensors)
    max_w = max(t.shape[1] for t in tensors)
    if size_divisible > 0:
        max_h = int(math.ceil(max_h / size_divisible) * size_divisible)
        max_w = int(math.ceil(max_w / size_divisible) * size_divisible)
    if target_shape is not None:
        th, tw = target_shape
        if th < max_h or tw < max_w:
            raise ValueError("target_shape {} smaller than batch max {}".format(
                target_shape, (max_h, max_w)))
        max_h, max_w = th, tw
    shape = (len(tensors), max_h, max_w, tensors[0].shape[2])
    first = tensors[0]
    if isinstance(first, torch.Tensor):
        batch = torch.zeros(shape, dtype=first.dtype, device=first.device)
    else:
        batch = np.zeros(shape, dtype=first.dtype)
    for i, t in enumerate(tensors):
        batch[i, :t.shape[0], :t.shape[1]] = t
    return ImageList(batch, [t.shape[:2] for t in tensors])
