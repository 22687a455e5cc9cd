"""The least time of the kernels' work at a step's shapes (the rooflines'
numerators), counted from the configuration and the cell's shapes.

A frozen copy of chip_smoke.py's ``bound`` and its per-site counts: each
input byte read once and each output byte written once, whatever a kernel
reads again, at 3.35 TB/s, or float32 operations at 67 TFLOP/s, whichever
is longer (one H100 SXM, NVIDIA's data sheet). Where the work depends on
the data (NMS's IoU tests) only the bytes are counted, a lower bound of
the least time: the share read from it can only be lower than the true one.
"""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# dense bf16 tensor-core peak of one H100 SXM, NVIDIA's data sheet
PEAK_BF16_FLOPS = 989e12
ELEMENT = {"bfloat16": 2, "float32": 4}


def bound_s(nbytes, ops=0):
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def _pyramid_cells(maps, levels):
    return sum(h * w for h, w in maps[:levels])


def pooler_bytes(cfg, batch, maps):
    """Bytes of one training step's ROI pooling, box and mask, forward
    (ROIs in, pooled features out) and backward (the pooled gradient in, the
    gradient of every level pooled from out)."""
    m = cfg["MODEL"]
    h = m["ROI_HEADS"]
    e = ELEMENT[cfg["TPU"]["COMPUTE_DTYPE"]]
    c = m["RESNETS"]["BACKBONE_OUT_CHANNELS"]
    box = m["ROI_BOX_HEAD"]
    mask = m["ROI_MASK_HEAD"]
    rois = batch * h["BATCH_SIZE_PER_IMAGE"]
    masks = batch * min(int(h["BATCH_SIZE_PER_IMAGE"] * h["POSITIVE_FRACTION"]),
                        cfg["TPU"]["MASK_ROI_CAP"])
    mcfg = box if mask["SHARE_BOX_FEATURE_EXTRACTOR"] else mask
    total = 0
    for r, pcfg in ((rois, box), (masks, mcfg)):
        p = pcfg["POOLER_RESOLUTION"]
        pooled = r * p * p * c * e
        grad = batch * _pyramid_cells(maps, len(pcfg["POOLER_SCALES"])) * c * e
        total += r * 20 + pooled + pooled + grad
    return total


def nms_bytes(lanes, n):
    """boxes, scores and valid in, keep out, of [lanes, n]."""
    return lanes * n * (16 + 4 + 1) + lanes * n


def matcher_bytes(batch, anchors, gt):
    """anchors and gt (boxes, valid) in, matches out."""
    return anchors * 16 + batch * gt * 17 + batch * anchors * 4


def rpn_lanes(cfg, batch, maps, train):
    """(lanes, boxes a lane) of the RPN's NMS."""
    r = cfg["MODEL"]["RPN"]
    phase = "TRAIN" if train else "TEST"
    per_loc = len(r["ASPECT_RATIOS"]) * (len(r["ANCHOR_SIZES"]) if len(maps) == 1 else 1)
    k = max(min(r["PRE_NMS_TOP_N_" + phase], hh * ww * per_loc) for hh, ww in maps)
    return len(maps) * batch, k


def box_nms_lanes(cfg, batch, maps):
    """(lanes, boxes a lane) of the box post-process's NMS: one lane an
    (image, class), the class's top-k prefilter."""
    m = cfg["MODEL"]
    fpn = len(maps) > 1
    n = m["RPN"]["FPN_POST_NMS_TOP_N_TEST"] if fpn else m["RPN"]["POST_NMS_TOP_N_TEST"]
    d = m["ROI_HEADS"]["DETECTIONS_PER_IMG"]
    return batch * (m["ROI_BOX_HEAD"]["NUM_CLASSES"] - 1), min(n, max(2 * d, 128))
