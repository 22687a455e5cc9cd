"""The work of one step of a ResNet-50 Mask R-CNN, C4 or FPN (the
configurations mask_rcnn_R_50_C4_1x and mask_rcnn_R_50_FPN_1x name it as
their "counts"): model FLOPs (flops.py) and the least seconds of the ROI
pooling, the NMS and the matcher (roofline.py) at the cell's shapes."""

from ..harness import traffic as gen
from . import flops, roofline


def step_counts(cfg, batch, hw, train):
    """Per step of `batch` images padded to hw: "flops", and the least
    seconds "pooler_bound_s" and "nms_matcher_bound_s" (training) or
    "nms_bound_s" (inference)."""
    fwd, bwd = flops.step_flops(cfg, batch, hw, train)
    maps = gen.feature_sizes(hw[0], hw[1], cfg)
    lanes, n = roofline.rpn_lanes(cfg, batch, maps, train)
    nms = roofline.nms_bytes(lanes, n)
    out = {"flops": fwd + bwd}
    if train:
        anchors, _ = gen.draw_counts(hw, cfg)
        out["pooler_bound_s"] = roofline.bound_s(roofline.pooler_bytes(cfg, batch, maps))
        out["nms_matcher_bound_s"] = roofline.bound_s(
            nms + roofline.matcher_bytes(batch, anchors, cfg["TPU"]["MAX_GT_BOXES"]))
    else:
        blanes, bn = roofline.box_nms_lanes(cfg, batch, maps)
        out["nms_bound_s"] = roofline.bound_s(nms + roofline.nms_bytes(blanes, bn))
    return out
