"""Anchor generation: Detectron-exact cell anchors and per-level grids.

PyTorch counterpart of maskrcnn_tpu/models/anchors.py. Cell anchors are
computed once in numpy (the same legacy round()ed enumeration); the grids
are built on the device of the feature map they belong to. Copying a
level's cell anchors there is a blocking copy from pageable host memory:
the host waits for everything queued on the stream, in a span
"anchors.wait" (utils/profiling.py:span).
"""

import numpy as np
import torch

from ..utils.profiling import span


def _whctrs(anchor):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    return w, h, anchor[0] + 0.5 * (w - 1), anchor[1] + 0.5 * (h - 1)


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack(
        (
            x_ctr - 0.5 * (ws - 1),
            y_ctr - 0.5 * (hs - 1),
            x_ctr + 0.5 * (ws - 1),
            y_ctr + 0.5 * (hs - 1),
        )
    )


def _ratio_enum(anchor, ratios):
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    size = w * h
    ws = np.round(np.sqrt(size / ratios))
    hs = np.round(ws * ratios)
    return _mkanchors(ws, hs, x_ctr, y_ctr)


def _scale_enum(anchor, scales):
    w, h, x_ctr, y_ctr = _whctrs(anchor)
    return _mkanchors(w * scales, h * scales, x_ctr, y_ctr)


def generate_cell_anchors(stride=16, sizes=(32, 64, 128, 256, 512),
                          aspect_ratios=(0.5, 1, 2)):
    """[A, 4] float32 anchors centred on the (0, 0) cell."""
    scales = np.array(sizes, np.float64) / stride
    ratios = np.array(aspect_ratios, np.float64)
    base = np.array([1, 1, stride, stride], np.float64) - 1
    anchors = _ratio_enum(base, ratios)
    anchors = np.vstack(
        [_scale_enum(anchors[i], scales) for i in range(anchors.shape[0])]
    )
    return anchors.astype(np.float32)


class AnchorGenerator:
    """One cell-anchor set per FPN level. A level's size may be a tuple of
    sizes (RetinaNet's octave scales): its cells then hold every size at
    every ratio, ratio-major, as the JAX AnchorGeneratorConfig. With one
    stride (the C4 models' single level) the one set holds every size at
    every ratio: 15 anchors a location at the default sizes and ratios."""

    def __init__(self, sizes, aspect_ratios, strides, straddle_thresh=0):
        self.straddle_thresh = straddle_thresh
        if len(strides) == 1:
            self.cell_anchors = [generate_cell_anchors(strides[0], sizes, aspect_ratios)]
        elif len(strides) != len(sizes):
            raise ValueError("FPN needs one anchor size per stride")
        else:
            self.cell_anchors = [
                generate_cell_anchors(stride,
                                      size if isinstance(size, (tuple, list)) else (size,),
                                      aspect_ratios)
                for stride, size in zip(strides, sizes)
            ]
        self.strides = list(strides)

    def num_anchors_per_location(self):
        return [len(c) for c in self.cell_anchors]

    def grid_anchors_level(self, level, grid_h, grid_w, device):
        """[grid_h * grid_w * A, 4] float32, ordered (y, x, anchor)."""
        with span("anchors.wait"):
            cell = torch.as_tensor(self.cell_anchors[level], device=device)
        stride = self.strides[level]
        shifts_x = torch.arange(grid_w, dtype=torch.float32, device=device) * stride
        shifts_y = torch.arange(grid_h, dtype=torch.float32, device=device) * stride
        sy, sx = torch.meshgrid(shifts_y, shifts_x, indexing="ij")
        sx = sx.reshape(-1)
        sy = sy.reshape(-1)
        shifts = torch.stack([sx, sy, sx, sy], dim=1)
        return (shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4)

    def visibility(self, anchors, image_h, image_w):
        """Anchors inside the image by the straddle threshold: anchors
        [N, 4], image_h and image_w broadcastable to [..., N] (e.g. [B, 1]
        float) -> bool [..., N]. A negative threshold keeps every anchor."""
        t = self.straddle_thresh
        if t < 0:
            return torch.ones(torch.broadcast_shapes(anchors.shape[:-1], image_h.shape),
                              dtype=torch.bool, device=anchors.device)
        return ((anchors[..., 0] >= -t) & (anchors[..., 1] >= -t)
                & (anchors[..., 2] < image_w + t) & (anchors[..., 3] < image_h + t))


def make_anchor_generator(cfg):
    r = cfg.MODEL.RPN
    if not r.USE_FPN and len(r.ANCHOR_STRIDE) != 1:
        raise ValueError("a single-level RPN takes one ANCHOR_STRIDE, not {}".format(
            r.ANCHOR_STRIDE))
    return AnchorGenerator(r.ANCHOR_SIZES, r.ASPECT_RATIOS, r.ANCHOR_STRIDE,
                           r.STRADDLE_THRESH)


def make_anchor_generator_retinanet(cfg):
    """RetinaNet's anchors: at each stride SCALES_PER_OCTAVE sizes
    OCTAVE ** (i / SCALES_PER_OCTAVE) * size by each ratio. RetinaNet takes
    no straddle visibility (every anchor is matched)."""
    c = cfg.MODEL.RETINANET
    sizes = [tuple(c.OCTAVE ** (i / float(c.SCALES_PER_OCTAVE)) * size
                   for i in range(c.SCALES_PER_OCTAVE)) for size in c.ANCHOR_SIZES]
    return AnchorGenerator(sizes, c.ASPECT_RATIOS, c.ANCHOR_STRIDES, c.STRADDLE_THRESH)
