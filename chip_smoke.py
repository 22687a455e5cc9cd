#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (maskrcnn_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:
  1. the card's name and power limit (nvidia-smi); every CUDA kernel of the
     port built from maskrcnn_tpu_torch/csrc by nvcc, and the host mask
     rasterizer by the C++ compiler, one process per source, all started
     together, with ptxas's register and spill report.
Serving:
  2. the flagship Mask R-CNN R-50-FPN at full width from the port's seeded
     init, bfloat16 compute. ROI_HEADS.SCORE_THRESH is lowered to 0: random
     weights give near-uniform class scores below the default 0.05, and the
     mask head should pool real boxes;
  3. four requests of COCO-like sizes after one warm-up, through
     Predictor.compute_prediction, each with its latency;
  4. the launch counts of that run: NMS twice and ROIAlign twice a request,
     no matcher and no ROIAlign backward;
  5. each kernel against its plain PyTorch version on the inputs the main
     path fed it in the first request, timed with CUDA events beside the
     least time the card could take for the same work (NMS also launch by
     launch under torch.profiler);
  6. the outputs: finite and of the expected shapes, and the same weights in
     float32 on a small image agreeing between the card (kernels) and the
     CPU (plain versions).
Training (a second model instance):
  7. the flagship at full width, bfloat16 compute, on bench.py's synthetic
     batch (8 images of 800x1344, COCO-like gt), SGD from the port's solver:
     one warm-up step, one counted step, then timed steps, each step's
     losses finite; trainable parameters moved, frozen ones (stem, layer1)
     did not;
  8. the launch counts of the counted step: matcher 1, NMS 1, ROIAlign
     forward 2, the default "roi" ROIAlign backward 2;
  9. each kernel against its plain version on the inputs that step fed it,
     timed beside its bound (NMS and the matcher also launch by launch); the
     three ROIAlign backwards ("roi", "rmw", "chunk") each on the gradients
     that step gave the two poolers, and two calls of "roi" giving the same
     bits;
 10. one float32 step on a small batch, the same weights and sampler draws
     on the card (kernels) and on the CPU (plain versions): losses and a
     handful of gradients agree; then again with the "rmw" backward at P=7
     and "chunk" at P=14;
 11. training img/s and MFU (FLOPs of one step from FlopCounterMode against
     the H100's 989 TFLOP/s dense bf16), the step's peak memory, and a
     torch.profiler breakdown of two steps' device time, in which the "roi"
     backward runs no scatter and no cast.
The training entry point (a third model instance):
 12. a synthetic COCO-format tree of 32 images of 480x640 from the seed,
     with bench.py's gt statistics and polygon masks; the images are handed
     to COCODataset by overriding its _load_image (the card's machine has
     no image decoder); MODEL.WEIGHT, the seeded flagship with frozen-BN
     statistics from 8 of the images;
 13. python -m maskrcnn_tpu_torch.tools.train_net's main, in-process, on the
     flagship at full width (its keys as KEY VALUE overrides: no YAML on the
     card), batch 8 at 800x1333, 4 DataLoader workers, 8 iterations with a
     checkpoint every 4, MASKRCNN_POOLER_BWD_P7=rmw and _P14=chunk: launches
     per step (matcher 1, NMS 1, ROIAlign forward 2, "rmw" 1, "chunk" 1,
     "roi" 0), the logged iterations, the checkpoint files, finite losses,
     s/iter, img/s, the share of the time spent waiting for the loader, and
     the loader's own rate at these settings (24 batches past its first);
 14. a resumed run to 12: it loads model_final, starts from the saved
     parameters and logs no iteration below 9.
Then the redesigned kernels' times (NMS, the matcher, the ROIAlign forward
and "roi" backward) beside their earlier designs' (PERF.md), one JSON line of
the six kernels, the card's line, and the result line.
"""

import contextlib
import json
import logging
import math
import os
import re
import shutil
import tempfile
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
REQUEST_SIZES = ((480, 640), (427, 640), (640, 480), (375, 500))
SEED = 0
# bench.py's training batch
TRAIN_BATCH, TRAIN_HW, TRAIN_SIZE = 8, (800, 1344), (800, 1333)
TIMED_STEPS = 5
# Published H100 SXM peaks at 700 W: HBM bandwidth, float32 arithmetic
# outside the tensor cores (all four kernels run on the CUDA cores), and
# dense bf16 on the tensor cores (for the step's MFU).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
# arithmetic per IoU test (min/max/sub/add/clamp per side, product, union,
# division, comparison) and per ROIAlign sample and channel (4 products,
# 3 sums, 1 accumulate; the backward's 4 products and 4 adds alike)
NMS_OPS_PER_PAIR = 15
ROI_OPS_PER_SAMPLE = 8
# The times of the redesigned kernels' earlier designs (PERF.md: this script
# on an NVIDIA H100 80GB HBM3 at 700 W), wrapper / kernel alone in ms, by
# (kernel, path, P) for ROIAlign and (kernel, path, lanes) for NMS and the
# matcher, printed beside this run's times.
EARLIER_MS = {
    ("nms", "serving", (5, 1000)): (0.2567, 0.1840), ("nms", "serving", (80, 200)): (0.2592, 0.0577),
    ("nms", "training", (40, 2000)): (0.6366, 0.5703),
    ("matcher", "training", (8, 268569)): (0.1264, 0.1223),
    ("roi_align", "serving", 7): (0.3146, 0.2187), ("roi_align", "serving", 14): (0.2642, 0.0954),
    ("roi_align", "training", 7): (0.8746, 0.8305), ("roi_align", "training", 14): (0.4711, 0.4263),
    ("roi_align_backward", "training", 7): (3.3741, 3.4335),
    ("roi_align_backward", "training", 14): (1.6866, 1.6799),
}


class SmokeError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def card_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, "nvidia-smi failed: " + proc.stderr.strip())
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters, warmup=2):
    """Mean milliseconds of fn() on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class Capture:
    """Records the arguments of a kernel wrapper where the model's modules
    call it (the module attribute `name`), while active; with grads=True
    also the gradient that reaches each call's output in the backward."""

    def __init__(self, modules, name, grads=False):
        self.modules, self.name, self.calls = modules, name, []
        self.grads, self.out_grads = grads, {}

    def __enter__(self):
        self.saved = [getattr(m, self.name) for m in self.modules]
        for m, fn in zip(self.modules, self.saved):
            setattr(m, self.name, self._recording(fn))
        return self

    def _recording(self, fn):
        def wrapper(*args):
            self.calls.append(args)
            out = fn(*args)
            if self.grads and out.requires_grad:
                i = len(self.calls) - 1
                out.register_hook(lambda g: self.out_grads.__setitem__(i, g))
            return out
        return wrapper

    def __exit__(self, *exc):
        for m, fn in zip(self.modules, self.saved):
            setattr(m, self.name, fn)


def training_counters(poolers, matcher, nms):
    """The launch counters of the kernels a training step may run."""
    return {"matcher": matcher.match_anchors_batched, "nms": nms.batched_nms,
            "roi_align": poolers.multilevel_roi_align,
            "roi_align_backward": poolers.roi_align_backward,
            "roi_align_backward_rmw": poolers.roi_align_backward_rmw,
            "roi_align_backward_chunk": poolers.roi_align_backward_chunk}


@contextlib.contextmanager
def environ(**values):
    """Environment variables set for the duration of a block."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def launch_ms(torch, fn, iters=20):
    """{device kernel or memset name: ms per call of fn}, from torch.profiler
    (empty where the profiler sees no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def self_device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0].strip()[:60]:
            self_device_us(e) / 1e3 / iters for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and self_device_us(e) > 0}


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nms_site(torch, nms, boxes, scores, valid, thresh, plain_iters):
    got = nms.batched_nms(boxes, scores, valid, thresh)
    want = nms.batched_nms_plain(boxes, scores, valid, thresh)
    check(torch.equal(got, want), "NMS kernel disagrees with its plain version at {}"
          .format(tuple(boxes.shape)))
    # IoU tests the greedy scan needs on these inputs: every kept box
    # against each later valid box
    order, _, svalid = nms._sort_lanes(boxes, scores, valid)
    skeep = torch.gather(want, 1, order)
    later = svalid.flip(1).cumsum(1).flip(1) - svalid.long()
    pairs = int((skeep.long() * later).sum())
    g, n = scores.shape
    prepared = nms.prepare(boxes, scores, valid)
    keep = torch.empty((g, n), dtype=torch.bool, device=boxes.device)
    nbytes = g * n * (16 + 4 + 1) + g * n  # boxes, scores, valid in; keep out
    b_ms, b_by = bound(nbytes, NMS_OPS_PER_PAIR * pairs)
    return {
        "shape": [g, n], "iou_threshold": thresh, "kept": int(want.sum()),
        "max_abs_err": float((got != want).sum()),
        "ms": cuda_ms(torch, lambda: nms.batched_nms(boxes, scores, valid, thresh), 50),
        "kernel_ms": cuda_ms(torch, lambda: nms.launch(*prepared, keep, thresh), 50),
        "launch_ms": launch_ms(torch, lambda: nms.launch(*prepared, keep, thresh)),
        "plain_ms": cuda_ms(torch, lambda: nms.batched_nms_plain(boxes, scores, valid, thresh),
                            plain_iters, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "iou_tests": pairs,
    }


def roi_site(torch, poolers, feats, boxes, bidx, pcfg):
    roi = poolers.multilevel_roi_align
    plain = poolers.multilevel_roi_align_plain
    f32 = [f.float() for f in feats]
    err32 = (roi(f32, boxes, bidx, pcfg) - plain(f32, boxes, bidx, pcfg)).abs().max().item()
    check(err32 <= 1e-5, "ROIAlign kernel (float32) off by {} at P={}".format(err32, pcfg.output_size))
    got, want = roi(feats, boxes, bidx, pcfg), plain(feats, boxes, bidx, pcfg)
    err = (got.float() - want.float()).abs().max().item()
    limit = 1e-2 * max(f.abs().max().item() for f in feats)
    check(err <= limit, "ROIAlign kernel ({}) off by {} > {} at P={}".format(
        feats[0].dtype, err, limit, pcfg.output_size))
    # bytes: each feature cell a sample touches read once, boxes and image
    # indices read once, the pooled output written once
    index, _, outside = poolers.sample_corners([f.shape[:3] for f in feats], boxes, bidx, pcfg)
    cells = int(torch.unique(index[:, ~outside]).numel())
    r, p, s, c = boxes.shape[0], pcfg.output_size, pcfg.sampling_ratio, feats[0].shape[-1]
    item = feats[0].element_size()
    b32, i32 = boxes.contiguous(), bidx.to(torch.int32).contiguous()
    lvl = poolers.assign_levels(b32, pcfg).contiguous()
    out = torch.empty_like(got)
    nbytes = r * p * p * c * item + cells * c * item + r * (16 + 4)
    b_ms, b_by = bound(nbytes, r * p * p * c * (ROI_OPS_PER_SAMPLE * s * s + 1))
    return {
        "rois": r, "P": p, "dtype": str(feats[0].dtype).replace("torch.", ""),
        "max_abs_err": err, "max_abs_err_float32": err32, "cells_read": cells,
        "ms": cuda_ms(torch, lambda: roi(feats, boxes, bidx, pcfg), 50),
        "kernel_ms": cuda_ms(torch, lambda: poolers.launch(feats, b32, i32, lvl, pcfg, out), 50),
        "plain_ms": cuda_ms(torch, lambda: plain(feats, boxes, bidx, pcfg), 10),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def matcher_site(torch, matcher, anchors, gt_boxes, gt_valid, high, low):
    got = matcher.match_anchors_batched(anchors, gt_boxes, gt_valid, high, low)
    want = matcher.match_anchors_plain(anchors, gt_boxes, gt_valid, high, low)
    check(torch.equal(got, want), "matcher kernel disagrees with its plain version")
    b, g = gt_valid.shape
    n = anchors.shape[0]
    best = torch.empty((b, g), dtype=torch.int32, device=anchors.device)
    out = torch.empty((b, n), dtype=torch.int32, device=anchors.device)
    inputs = (anchors.contiguous(), gt_boxes.contiguous(), gt_valid.contiguous())
    # bytes: anchors, gt and validity read once, the matches written once;
    # operations: one IoU test of every anchor with every valid gt
    valid_gt = int(gt_valid.sum())
    b_ms, b_by = bound(16 * n + 17 * b * g + 4 * b * n, NMS_OPS_PER_PAIR * n * valid_gt)
    return {
        "anchors": n, "images": b, "gt_per_image": g, "valid_gt": valid_gt,
        "max_abs_err": float((got != want).sum()),
        "ms": cuda_ms(torch, lambda: matcher.match_anchors_batched(
            anchors, gt_boxes, gt_valid, high, low), 50),
        "kernel_ms": cuda_ms(torch, lambda: matcher.launch(*inputs, high, low, best, out), 50),
        "launch_ms": launch_ms(torch, lambda: matcher.launch(*inputs, high, low, best, out)),
        "plain_ms": cuda_ms(torch, lambda: matcher.match_anchors_plain(
            anchors, gt_boxes, gt_valid, high, low), 5, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
    }


def roi_backward_site(torch, poolers, feats, boxes, bidx, pcfg, dout, kind="roi"):
    """The backward kernel `kind` ("roi", "rmw" or "chunk") on the gradient
    the step's backward gave the pooled output, against autograd through the
    plain float32 forward; for the window backwards also the shape of their
    layout on these ROIs."""
    shapes = [tuple(f.shape) for f in feats]
    b32, i32 = boxes.detach().contiguous(), bidx.to(torch.int32).contiguous()
    lvl = poolers.assign_levels(b32, pcfg).contiguous()
    wrapper = poolers.BACKWARD_KERNELS[kind]
    got = wrapper(dout, shapes, b32, i32, lvl, pcfg)
    got32 = wrapper(dout.float(), shapes, b32, i32, lvl, pcfg)
    if kind == "roi":  # a fixed order of sums: a second call gives the same bits
        again = wrapper(dout, shapes, b32, i32, lvl, pcfg)
        check(all(torch.equal(a, g) for a, g in zip(again, got)),
              "two calls of the roi backward differ at P={}".format(pcfg.output_size))
        del again
    leaves = [torch.zeros(sh, device=dout.device, requires_grad=True) for sh in shapes]
    plain_out = poolers.multilevel_roi_align_plain(leaves, b32, bidx, pcfg)
    want = torch.autograd.grad(plain_out, leaves, dout.float(), retain_graph=True)
    scale = max(w.abs().max().item() for w in want)
    err32 = max((g - w).abs().max().item() for g, w in zip(got32, want))
    err = max((g.float() - w).abs().max().item() for g, w in zip(got, want))
    check(scale > 0, "ROIAlign backward: zero gradient at P={}".format(pcfg.output_size))
    check(err32 <= 1e-5 * scale, "ROIAlign {} backward kernel (float32) off by {} > 1e-5 * {}"
          .format(kind, err32, scale))
    check(err <= 1e-2 * scale, "ROIAlign {} backward kernel ({}) off by {} > 1e-2 * {}".format(
        kind, dout.dtype, err, scale))
    total = sum(math.prod(sh) for sh in shapes)
    # the window backwards' float32 sums; the roi backward writes out alone
    acc = None if kind == "roi" else torch.empty((total,), dtype=torch.float32,
                                                 device=dout.device)
    out = torch.empty((total,), dtype=dout.dtype, device=dout.device)
    dc = dout.contiguous()
    r, p, s, c = dout.shape[0], pcfg.output_size, pcfg.sampling_ratio, dout.shape[-1]
    item = dout.element_size()
    # bytes: dOut, boxes and image indices read once, the dense gradient of
    # every pooled level written once in the compute dtype
    b_ms, b_by = bound(dout.numel() * item + r * 20 + total * item,
                       r * p * p * c * (ROI_OPS_PER_SAMPLE * s * s + 1))
    site = {"kind": kind, "rois": r, "P": p, "dtype": str(dout.dtype).replace("torch.", "")}
    if kind == "roi":
        inputs = poolers.roi_tile_inputs(shapes, i32, lvl)
        # how the ROIs load the tiles: the crowded tiles set the kernel's time
        per_tile = [len(v) for v in poolers.tile_lists(shapes, b32.cpu(), i32.cpu(), lvl.cpu(),
                                                         pcfg).values()]
        site.update(bitwise_repeatable=True,
                    rois_per_level=torch.bincount(lvl.long(), minlength=len(shapes)).tolist(),
                    tiles=sum(-(-sh[1] // poolers.TILE) * -(-sh[2] // poolers.TILE) * sh[0]
                              for sh in shapes),
                    tiles_met=len(per_tile), tile_roi_pairs=sum(per_tile),
                    rois_per_tile_max=max(per_tile, default=0),
                    tiles_met_by_100_rois_or_more=sum(n >= 100 for n in per_tile))
    else:
        inputs = poolers.window_kernel_inputs(kind, shapes, b32, i32, lvl, pcfg)
        lay = inputs["layout"]
        per_window = torch.bincount(lay["rwid"][:r])
        site.update(windows=int(per_window.numel()), rois_per_window_mean=r / per_window.numel(),
                    rois_per_window_max=int(per_window.max()),
                    oversize_rois=int(lay["oversize"].sum()))
        if kind == "chunk":
            pure = inputs["chunks"]["pure"]
            site.update(chunks=int(pure.numel()), pure_chunk_share=float(pure.float().mean()))
    site.update({
        "max_abs_err": err, "max_abs_err_float32": err32, "max_abs_grad": scale,
        "ms": cuda_ms(torch, lambda: wrapper(dout, shapes, b32, i32, lvl, pcfg), 20),
        "kernel_ms": cuda_ms(torch, lambda: poolers.launch_backward(
            shapes, b32, i32, lvl, pcfg, dc, acc, out, kind, inputs), 20),
        "plain_ms": cuda_ms(torch, lambda: torch.autograd.grad(
            plain_out, leaves, dout.float(), retain_graph=True), 5, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
    })
    return site


def kernel_entry(name, source, replaces, launches, sites):
    """One kernel's line entry: times are means per launch over the main
    paths' call sites; launches is {path: count in that path's run}, and
    "launches" their sum; sites has each site."""
    mean = lambda k: sum(s[k] for s in sites) / len(sites)  # noqa: E731
    by = [s["bound_by"] for s in sites]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(launches.values()), "launches_by_path": launches,
        "max_abs_err": max(s["max_abs_err"] for s in sites),
        "ms": mean("ms"), "kernel_ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": max(set(by), key=by.count), "library_ms": None, "sites": sites,
    }


def calibrate_frozen_bn(torch, model, images):
    """Set every frozen BN of the backbone body from one batch, layer by
    layer: running mean and variance (+1e-5) of the conv output it follows,
    weight 1, bias 0. Random weights with identity BN let activations grow
    by orders of magnitude through the 16 residual blocks; a trained
    model's BN keeps them near unit scale, and so does this."""
    import torch.nn.functional as F

    from maskrcnn_tpu_torch.models import resnet

    folded = resnet.conv_frozen_bn

    def calibrating(x, conv, bn):
        y = F.conv2d(x, conv.weight, None, conv.stride, conv.padding, conv.dilation,
                     conv.groups)
        bn.weight.fill_(1.0)
        bn.bias.zero_()
        bn.running_mean.copy_(y.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(y.var(dim=(0, 2, 3)) + 1e-5)
        return folded(x, conv, bn)

    resnet.conv_frozen_bn = calibrating
    try:
        with torch.no_grad():
            x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            model.backbone.body(x)
    finally:
        resnet.conv_frozen_bn = folded


def match_detections(a, b):
    """Fraction of a's detections with a partner in b: same label, score
    within 1e-4, box within 1e-2 px, mask probabilities within 1e-3."""
    matched = 0
    for i in range(len(a["scores"])):
        for j in range(len(b["scores"])):
            if (a["labels"][i] == b["labels"][j]
                    and abs(a["scores"][i] - b["scores"][j]) <= 1e-4
                    and abs(a["boxes"][i] - b["boxes"][j]).max() <= 1e-2
                    and abs(a["masks"][i] - b["masks"][j]).max() <= 1e-3):
                matched += 1
                break
    return matched / max(len(a["scores"]), 1)


def run(torch):
    sys.path.insert(0, REPO)
    import numpy as np

    from maskrcnn_tpu_torch.config import flagship_cfg
    from maskrcnn_tpu_torch.models import detector, poolers, rpn
    from maskrcnn_tpu_torch.models.roi_heads import box_head
    from maskrcnn_tpu_torch.ops import matcher, native, nms
    from maskrcnn_tpu_torch.predictor import Predictor

    # 1. card and build
    card = card_line()
    print("card:", card, flush=True)
    t0 = time.perf_counter()
    logs = native.build(native.KERNELS + native.HOST_LIBS)
    print("built {} in {:.1f} s ({})".format(
        ", ".join(native.KERNELS + native.HOST_LIBS), time.perf_counter() - t0,
        "compiled: " + ", ".join(logs) if logs else "already built"), flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  {}: {}".format(name, line.strip()))
    for name in native.KERNELS:
        native.load(name)

    # 2. model
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = flagship_cfg()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.MODEL.ROI_HEADS.SCORE_THRESH = 0.0
    print("config: Mask R-CNN R-50-FPN, full width, bfloat16 compute; ROI_HEADS.SCORE_THRESH "
          "lowered to 0.0 (random weights, seed {})".format(SEED), flush=True)
    rs = np.random.RandomState(SEED)
    warm = rs.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    images = [rs.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in REQUEST_SIZES]
    t0 = time.perf_counter()
    pred = Predictor(cfg, device="cuda", seed=SEED)
    calibrate_frozen_bn(torch, pred.model, pred.preprocess(warm)[0])
    torch.cuda.synchronize()
    print("model built in {:.1f} s; frozen-BN statistics set from the warm-up image"
          .format(time.perf_counter() - t0), flush=True)

    # 3. requests
    t0 = time.perf_counter()
    pred.compute_prediction(warm)
    print("warm-up request: {:.1f} ms".format((time.perf_counter() - t0) * 1e3), flush=True)

    results, latencies = [], []

    def serve(img):
        t0 = time.perf_counter()
        results.append(pred.compute_prediction(img))  # ends in copies to the host
        latencies.append((time.perf_counter() - t0) * 1e3)
        print("request {} {}x{}: {:.2f} ms, {} detections [{}]".format(
            len(results) - 1, img.shape[0], img.shape[1], latencies[-1],
            len(results[-1]["scores"]), card), flush=True)

    counters = training_counters(poolers, matcher, nms)
    for fn in counters.values():
        fn.launches = 0
    with Capture([rpn, box_head], "batched_nms") as nms_cap, \
            Capture([detector], "multilevel_roi_align") as roi_cap:
        serve(images[0])
    for img in images[1:]:
        serve(img)
    serving = {k: fn.launches for k, fn in counters.items()}
    n_nms, n_roi = serving["nms"], serving["roi_align"]

    # 4. launch counts of the main path
    print("launches in {} requests: {}".format(len(images), json.dumps(serving)))
    check(all(serving[k] == 0 for k in serving if k not in ("nms", "roi_align")),
          "serving launched training kernels")
    check(n_nms == 2 * len(images), "NMS kernel launched {} times, expected {}"
          .format(n_nms, 2 * len(images)))
    check(n_roi == 2 * len(images), "ROIAlign kernel launched {} times, expected {}"
          .format(n_roi, 2 * len(images)))

    # the same requests again, every shape now seen once
    seen = []
    for img in images:
        t0 = time.perf_counter()
        pred.compute_prediction(img)
        seen.append((time.perf_counter() - t0) * 1e3)
    print("second pass, shapes seen: " + ", ".join("{:.2f} ms".format(t) for t in seen))

    # 5. kernels against their plain versions on the main path's inputs
    check(len(nms_cap.calls) == 2 and len(roi_cap.calls) == 2,
          "captured {} NMS and {} ROIAlign calls in one request"
          .format(len(nms_cap.calls), len(roi_cap.calls)))
    with torch.inference_mode():
        nms_sites = [nms_site(torch, nms, *call, plain_iters=3) for call in nms_cap.calls]
        roi_sites = [roi_site(torch, poolers, *call) for call in roi_cap.calls]
    (g0, n0), (g1, n1) = nms_sites[0]["shape"], nms_sites[1]["shape"]
    check((g0, n0) == (5, 1000) and (g1, n1) == (80, 200),
          "NMS lanes {} and {}, expected [5, 1000] and [80, 200]".format((g0, n0), (g1, n1)))
    check((roi_sites[0]["rois"], roi_sites[0]["P"]) == (1000, 7)
          and (roi_sites[1]["rois"], roi_sites[1]["P"]) == (100, 14),
          "ROIAlign sites {}".format([(s["rois"], s["P"]) for s in roi_sites]))
    for s in nms_sites + roi_sites:
        print("kernel site:", json.dumps(s), flush=True)

    # 6. outputs
    for k, (img, out) in enumerate(zip(images, results)):
        n = len(out["scores"])
        h, w = img.shape[:2]
        check(0 < n <= cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG, "request {}: {} detections".format(k, n))
        check(out["boxes"].shape == (n, 4) and np.isfinite(out["boxes"]).all(), "bad boxes")
        check(np.isfinite(out["scores"]).all() and (out["scores"] >= 0).all()
              and (out["scores"] <= 1).all(), "bad scores")
        check(((out["labels"] >= 1) & (out["labels"] <= 80)).all(), "bad labels")
        check(out["masks"].shape == (n, h, w) and out["masks"].dtype == np.uint8, "bad masks")
        check((out["boxes"][:, [0, 2]] <= w * 1.001).all() and (out["boxes"][:, [1, 3]] <= h * 1.001).all(),
              "boxes outside the image")
    ref = reference_check(torch, np, detector, cfg, pred.model.state_dict())
    print("float32 card vs CPU on a 256x320 image: " + json.dumps(ref), flush=True)
    check(ref["agree"] >= 0.9, "card and CPU disagree on {:.1%} of detections"
          .format(1 - ref["agree"]))

    print("latency ms per request: " + json.dumps(latencies)
          + "; second pass: " + json.dumps(seen), flush=True)
    del pred, results
    torch.cuda.empty_cache()

    tr = train_phase(torch, np, card)
    torch.cuda.empty_cache()
    entry = entry_point_phase(torch, np, card, tr["throughput"])

    def by_path(key):
        return {"serving": serving[key], "training": tr["launches"][key],
                "entry_point": entry["launches"][key]}

    roi_cu = "maskrcnn_tpu_torch/csrc/roi_align.cu"
    tpu = "maskrcnn_tpu/ops/pallas/"
    kernels = [
        kernel_entry("nms", "maskrcnn_tpu_torch/csrc/nms.cu", tpu + "nms_kernel.py:161",
                     by_path("nms"), nms_sites + tr["nms_sites"]),
        kernel_entry("roi_align", roi_cu, tpu + "roi_align_kernel.py:434", by_path("roi_align"),
                     roi_sites + tr["roi_sites"]),
        kernel_entry("roi_align_backward", roi_cu, tpu + "roi_align_kernel.py:1020",
                     by_path("roi_align_backward"), tr["bwd_sites_roi"]),
        kernel_entry("roi_align_backward_rmw", roi_cu, tpu + "roi_align_kernel.py:646",
                     by_path("roi_align_backward_rmw"), tr["bwd_sites_rmw"]),
        kernel_entry("roi_align_backward_chunk", roi_cu, tpu + "roi_align_kernel.py:850",
                     by_path("roi_align_backward_chunk"), tr["bwd_sites_chunk"]),
        kernel_entry("matcher", "maskrcnn_tpu_torch/csrc/matcher.cu",
                     tpu + "matcher_kernel.py:183", by_path("matcher"), tr["matcher_sites"]),
    ]

    def shape(name, s):
        if name == "nms":
            return tuple(s["shape"])
        return (s["images"], s["anchors"]) if name == "matcher" else s["P"]

    redesigned = [
        {"kernel": name, "path": path, "shape": shape(name, s), "ms": s["ms"],
         "kernel_ms": s["kernel_ms"], "launch_ms": s.get("launch_ms"), "bound_ms": s["bound_ms"],
         "earlier_ms": EARLIER_MS[(name, path, shape(name, s))][0],
         "earlier_kernel_ms": EARLIER_MS[(name, path, shape(name, s))][1]}
        for name, path, sites in (("nms", "serving", nms_sites),
                                  ("nms", "training", tr["nms_sites"]),
                                  ("matcher", "training", tr["matcher_sites"]),
                                  ("roi_align", "serving", roi_sites),
                                  ("roi_align", "training", tr["roi_sites"]),
                                  ("roi_align_backward", "training", tr["bwd_sites_roi"]))
        for s in sites]
    print("redesigned kernels, this run against the earlier designs' times in PERF.md "
          "[{}]: {}".format(card, json.dumps(redesigned)), flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    return torch.cuda.get_device_name(0), torch.cuda.device_count()


def train_batch(torch, np, b, hw, sizes, gt_per_image, mask_size, seed, device,
                block_masks=False):
    """bench.py's synthetic training batch: float32 images (standard normal,
    as if normalized), COCO-like gt (lognormal instance counts of mean ~7,
    log-uniform sides of 16-500 px), random labels and binary gt mask
    patches (per pixel, or in 4 x 4 blocks with block_masks)."""
    h, w = hw
    g = gt_per_image
    rs = np.random.RandomState(seed)
    gt_boxes = np.zeros((b, g, 4), np.float32)
    gt_labels = np.zeros((b, g), np.int32)
    for i in range(b):
        n_gt = int(np.clip(rs.lognormal(mean=1.7, sigma=0.8), 1, g))
        side = np.exp(rs.uniform(np.log(16), np.log(min(500, h, w)), (n_gt, 2)))
        ctr = rs.uniform(0, 1, (n_gt, 2)) * np.array([w - 1, h - 1])
        lo = np.clip(ctr - side / 2, 0, None)
        hi = np.minimum(ctr + side / 2, [w - 1, h - 1])
        hi = np.maximum(hi, lo + 2)
        gt_boxes[i, :n_gt, :2] = lo
        gt_boxes[i, :n_gt, 2:] = hi
        gt_labels[i, :n_gt] = rs.randint(1, 81, n_gt)
    images = rs.randn(b, h, w, 3).astype(np.float32)
    if block_masks:
        masks = (rs.rand(b, g, mask_size // 4, mask_size // 4) > 0.5).repeat(4, 2).repeat(4, 3)
    else:
        masks = rs.rand(b, g, mask_size, mask_size) > 0.5
    batch = dict(images=images, image_sizes=np.asarray([sizes] * b, np.int32),
                 gt_boxes=gt_boxes, gt_labels=gt_labels, gt_masks=masks.astype(np.uint8))
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train_phase(torch, np, card):
    from torch.utils.flop_counter import FlopCounterMode

    from maskrcnn_tpu_torch.config import flagship_cfg
    from maskrcnn_tpu_torch.engine import make_train_step
    from maskrcnn_tpu_torch.models import build_detection_model, detector, poolers, rpn
    from maskrcnn_tpu_torch.ops import matcher, nms
    from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer

    # 7. model, batch, optimizer
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = flagship_cfg()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    t0 = time.perf_counter()
    model = build_detection_model(cfg, device="cuda", seed=SEED)
    batch = train_batch(torch, np, TRAIN_BATCH, TRAIN_HW, TRAIN_SIZE, cfg.TPU.MAX_GT_BOXES,
                        cfg.TPU.GT_MASK_SIZE, SEED, "cuda")
    calibrate_frozen_bn(torch, model, batch["images"])
    opt = make_optimizer(cfg, model)
    sched = make_lr_scheduler(cfg, opt)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    step = make_train_step(model, opt, sched, generator=gen)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    print("training: Mask R-CNN R-50-FPN, full width, bfloat16 compute, batch {} of {}x{} "
          "(image sizes {}x{}), {} gt slots, frozen-BN statistics from the batch; built in "
          "{:.1f} s".format(TRAIN_BATCH, *TRAIN_HW, *TRAIN_SIZE, cfg.TPU.MAX_GT_BOXES,
                            time.perf_counter() - t0), flush=True)

    def show(tag, m, dt):
        losses = {k: v.item() for k, v in m.items()}
        check(all(math.isfinite(v) for v in losses.values()), "{}: loss not finite: {}"
              .format(tag, losses))
        print("{}: {:.1f} ms, {} [{}]".format(tag, dt * 1e3, json.dumps(losses), card),
              flush=True)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = step(batch)
    torch.cuda.synchronize()
    show("warm-up step", m, time.perf_counter() - t0)

    # 8. the counted step
    counters = training_counters(poolers, matcher, nms)
    for fn in counters.values():
        fn.launches = 0
    with Capture([rpn], "match_anchors_batched") as match_cap, \
            Capture([rpn], "batched_nms") as nms_cap, \
            Capture([detector], "multilevel_roi_align", grads=True) as roi_cap:
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    show("counted step", m, dt)
    print("launches in one training step: " + json.dumps(launches), flush=True)
    expected = {"matcher": 1, "nms": 1, "roi_align": 2, "roi_align_backward": 2,
                "roi_align_backward_rmw": 0, "roi_align_backward_chunk": 0}
    check(launches == expected, "training step launched {}, expected {}".format(
        launches, expected))

    times = []
    for i in range(TIMED_STEPS):
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        show("step {}".format(i), m, times[-1])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    check(frozen and all(n.startswith(("backbone.body.stem.", "backbone.body.layer1."))
                         for n in frozen), "unexpected frozen parameters")
    for n, p in model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        check(same != p.requires_grad, "{} parameter {} {} after {} steps".format(
            "trainable" if p.requires_grad else "frozen", n,
            "unchanged" if same else "changed", TIMED_STEPS + 2))
    print("after {} steps: {} trainable parameters moved, {} frozen (stem, layer1) did not"
          .format(TIMED_STEPS + 2, len(before) - len(frozen), len(frozen)), flush=True)

    # 9. kernels against their plain versions on the counted step's inputs
    check(len(match_cap.calls) == 1 and len(nms_cap.calls) == 1 and len(roi_cap.calls) == 2
          and len(roi_cap.out_grads) == 2, "captured {} matcher, {} NMS, {} ROIAlign calls"
          .format(len(match_cap.calls), len(nms_cap.calls), len(roi_cap.calls)))
    del before
    opt.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    sites = {"matcher_sites": [matcher_site(torch, matcher, *match_cap.calls[0])]}
    with torch.no_grad():
        sites["nms_sites"] = [nms_site(torch, nms, *nms_cap.calls[0], plain_iters=3)]
        sites["roi_sites"] = [roi_site(torch, poolers, [f.detach() for f in call[0]], *call[1:])
                              for call in roi_cap.calls]
    for kind in poolers.BACKWARDS:
        sites["bwd_sites_" + kind] = [
            roi_backward_site(torch, poolers, [f.detach() for f in call[0]], *call[1:],
                              roi_cap.out_grads[i], kind)
            for i, call in enumerate(roi_cap.calls)]
    del match_cap, nms_cap, roi_cap
    torch.cuda.empty_cache()
    g, n = sites["nms_sites"][0]["shape"]
    check((g, n) == (5 * TRAIN_BATCH, cfg.MODEL.RPN.PRE_NMS_TOP_N_TRAIN),
          "training NMS lanes {}".format((g, n)))
    box_rois = TRAIN_BATCH * cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE
    mask_rois = TRAIN_BATCH * cfg.TPU.MASK_ROI_CAP
    check([(x["rois"], x["P"]) for x in sites["roi_sites"]] == [(box_rois, 7), (mask_rois, 14)]
          and all([(x["rois"], x["P"]) for x in sites["bwd_sites_" + kind]]
                  == [(box_rois, 7), (mask_rois, 14)] for kind in poolers.BACKWARDS),
          "training ROIAlign sites {}".format([(x["rois"], x["P"]) for x in sites["roi_sites"]]))
    for k in ["matcher_sites", "nms_sites", "roi_sites"] + ["bwd_sites_" + kind
                                                           for kind in poolers.BACKWARDS]:
        for site in sites[k]:
            print("training kernel site:", json.dumps(site), flush=True)

    # 10. float32 card against CPU, with the default backward and again with
    # the window backwards
    state = model.state_dict()
    train_reference_check(torch, np, cfg, state, "roi")
    window_kernels = ("roi_align_backward_rmw", "roi_align_backward_chunk")
    before = {k: counters[k].launches for k in window_kernels}
    with environ(MASKRCNN_POOLER_BWD_P7="rmw", MASKRCNN_POOLER_BWD_P14="chunk"):
        train_reference_check(torch, np, cfg, state, "rmw at P=7, chunk at P=14")
    check(all(counters[k].launches == v + 1 for k, v in before.items()),
          "the float32 check did not run the window backwards")

    # 11. throughput
    torch.backends.cudnn.allow_tf32 = True
    with FlopCounterMode(display=False) as counter:
        losses = model.train_forward(batch, generator=gen)
        sum(losses.values()).backward()
    opt.zero_grad(set_to_none=True)
    flops = counter.get_total_flops()
    step_s = sum(times) / len(times)
    thr = {"img_per_s": TRAIN_BATCH / step_s, "step_ms": step_s * 1e3,
           "step_ms_each": [t * 1e3 for t in times], "flops_per_step": flops,
           "mfu": flops / step_s / BF16_FLOPS_PER_S, "peak_memory_gb": peak_gb,
           "card": card}
    print("training throughput: " + json.dumps(thr), flush=True)
    print("training step peak memory: {:.3f} GB (torch.cuda.max_memory_allocated over the "
          "warm-up, counted and timed steps) [{}]".format(peak_gb, card), flush=True)
    prof = profile_steps(torch, step, batch)
    print("training step profile: " + json.dumps(prof), flush=True)
    if prof["device_busy_ms"] != "not measured":
        # the roi backward writes its gradient whole: no scatter, no cast
        names = prof["roi_align_kernels_per_step"]
        check(not any("cast_to_bf16" in k or "roi_align_bwd_kernel" in k for k in names)
              and sum(v for k, v in names.items() if "bwd_tile" in k) == 2,
              "the step's ROIAlign kernels: {}".format(names))
    sites["launches"] = launches
    sites["throughput"] = thr
    return sites


def synthetic_coco(np, root, n=32, hw=(480, 640), seed=0):
    """A COCO-format training tree under root (coco_2017_train of the
    dataset catalog): n images of hw made from `seed` (returned as arrays
    by image id, not written: the card's machine has no image decoder) and
    annotations with bench.py's gt statistics at this image size
    (lognormal instance counts of mean ~7, log-uniform sides of 16-500 px
    scaled by 480/800, 80 categories), each instance an octagon polygon
    inscribed in its box."""
    rs = np.random.RandomState(seed)
    h, w = hw
    scale = min(hw) / 800
    images, infos, anns = {}, [], []
    angles = np.arange(8) * np.pi / 4
    for img_id in range(1, n + 1):
        images[img_id] = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        infos.append({"id": img_id, "file_name": "{:06d}.jpg".format(img_id), "height": h,
                      "width": w})
        n_gt = int(np.clip(rs.lognormal(mean=1.7, sigma=0.8), 1, 100))
        side = np.exp(rs.uniform(np.log(16 * scale), np.log(500 * scale), (n_gt, 2)))
        ctr = rs.uniform(0, 1, (n_gt, 2)) * np.array([w - 1, h - 1])
        lo = np.clip(ctr - side / 2, 0, None)
        hi = np.maximum(np.minimum(ctr + side / 2, [w - 1, h - 1]), lo + 2)
        for (x0, y0), (x1, y1) in zip(lo, hi):
            cx, cy, rx, ry = (x0 + x1) / 2, (y0 + y1) / 2, (x1 - x0) / 2, (y1 - y0) / 2
            poly = np.stack([cx + rx * np.cos(angles), cy + ry * np.sin(angles)], 1)
            anns.append({"id": len(anns) + 1, "image_id": img_id, "iscrowd": 0,
                         "category_id": int(rs.randint(1, 81)),
                         "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                         "area": float((x1 - x0) * (y1 - y0)),
                         "segmentation": [poly.ravel().tolist()]})
    os.makedirs(os.path.join(root, "coco", "annotations"))
    os.makedirs(os.path.join(root, "coco", "train2017"))
    with open(os.path.join(root, "coco", "annotations", "instances_train2017.json"), "w") as f:
        json.dump({"images": infos, "annotations": anns,
                   "categories": [{"id": c, "name": "class{}".format(c)} for c in range(1, 81)]},
                  f)
    return images, len(anns)


def config_opts(cfg, base, prefix=""):
    """KEY VALUE overrides that turn `base` into `cfg` (no YAML on the card)."""
    opts = []
    for k, v in cfg.items():
        if isinstance(v, dict):
            opts += config_opts(v, base[k], prefix + k + ".")
        elif v != base[k]:
            opts += [prefix + k, repr(v)]
    return opts


class LogLines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def entry_point_phase(torch, np, card, step_throughput):
    """12-14. The training entry point, python -m maskrcnn_tpu_torch.tools.train_net, run
    in-process on the flagship at full width: the dataset catalog, COCODataset, the
    transforms, the collator, the samplers and 4 DataLoader workers over a synthetic COCO
    tree, the trainer and the checkpointer, with the "rmw" backward at P=7 and "chunk" at
    P=14. 8 iterations with a checkpoint every 4, then a resumed run to 12."""
    from maskrcnn_tpu_torch.config import cfg as defaults
    from maskrcnn_tpu_torch.config import flagship_cfg
    from maskrcnn_tpu_torch.data.build import make_data_loader
    from maskrcnn_tpu_torch.data.datasets import COCODataset
    from maskrcnn_tpu_torch.models import build_detection_model, poolers
    from maskrcnn_tpu_torch.ops import matcher, nms
    from maskrcnn_tpu_torch.tools import train_net

    work = tempfile.mkdtemp(prefix="chip_smoke_")
    load_image = COCODataset._load_image
    do_train = train_net.do_train
    logs = LogLines()
    loggers = [logging.getLogger(n) for n in ("maskrcnn_tpu_torch",
                                              "maskrcnn_tpu_torch.checkpointer")]
    for lg in loggers:  # train_net's setup_logger then adds no console handler
        lg.addHandler(logs)
        lg.setLevel(logging.INFO)
        lg.propagate = False
    try:
        # 12. data and weights
        images, n_anns = synthetic_coco(np, work)
        COCODataset._load_image = lambda self, index: images[self.ids[index]]
        print("entry point: synthetic COCO tree of {} images of 480x640 (seed {}), {} polygon "
              "instances; COCODataset._load_image overridden to hand over the seeded arrays "
              "(no image decoder on the card)".format(len(images), SEED, n_anns), flush=True)
        cfg = flagship_cfg()
        model = build_detection_model(cfg, device="cuda", seed=SEED)
        first = torch.from_numpy(np.stack([images[i] for i in range(1, 9)])).cuda()
        sizes = torch.tensor([[480, 640]] * 8, dtype=torch.int32, device="cuda")
        calibrate_frozen_bn(torch, model, model._prepare_images(first, sizes))
        weights = os.path.join(work, "weights.pth")
        torch.save({"model": model.state_dict()}, weights)
        del model, first
        torch.cuda.empty_cache()
        out = os.path.join(work, "out")
        opts = config_opts(cfg, defaults) + [
            "MODEL.DEVICE", "cuda", "MODEL.WEIGHT", weights,
            "DATASETS.TRAIN", "('coco_2017_train',)", "SOLVER.IMS_PER_BATCH", "8",
            "INPUT.MIN_SIZE_TRAIN", "(800,)",
            "INPUT.MAX_SIZE_TRAIN", "1333", "SOLVER.CHECKPOINT_PERIOD", "4",
            "DATALOADER.NUM_WORKERS", "4", "OUTPUT_DIR", out]
        print("entry point: train_net --skip-test " + " ".join(opts) + " SOLVER.MAX_ITER 8, with "
              "MASKRCNN_POOLER_BWD_P7=rmw MASKRCNN_POOLER_BWD_P14=chunk; MODEL.WEIGHT: the "
              "seeded init with frozen-BN statistics from 8 of the images", flush=True)

        def logged_iterations():
            its = [int(m) for line in logs.lines for m in re.findall(r"iter: (\d+)", line)]
            logs.lines.clear()
            return its

        # 13. eight iterations through the entry point
        counters = training_counters(poolers, matcher, nms)
        with environ(MASKRCNN_TPU_DATA_DIR=work, MASKRCNN_POOLER_BWD_P7="rmw",
                     MASKRCNN_POOLER_BWD_P14="chunk"):
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            _, meters = train_net.main(["--skip-test"] + opts + ["SOLVER.MAX_ITER", "8"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
            lines = list(logs.lines)
            its = logged_iterations()
            for line in lines:
                if "iter:" in line or "non-finite" in line or "skipped" in line:
                    print("  train_net: " + line, flush=True)
            print("entry point launches in 8 iterations: " + json.dumps(launches), flush=True)
            per_step = {"matcher": 1, "nms": 1, "roi_align": 2, "roi_align_backward": 0,
                        "roi_align_backward_rmw": 1, "roi_align_backward_chunk": 1}
            check(launches == {k: 8 * v for k, v in per_step.items()},
                  "entry point launched {}, expected {} a step".format(launches, per_step))
            check(its == [8], "the first run logged iterations {}".format(its))
            for name in ("model_0000004.pth", "model_final.pth", "last_checkpoint"):
                check(os.path.exists(os.path.join(out, name)),
                      "no {} after 8 iterations".format(name))
            losses = {k: m.global_avg for k, m in meters.meters.items() if k.startswith("loss")}
            check(len(losses) == 6 and all(math.isfinite(v) for v in losses.values()),
                  "entry point losses {}".format(losses))
            times = list(meters.meters["time"].deque)
            waits = list(meters.meters["data"].deque)
            step_s = meters.meters["time"].median
            # the loader alone at the same settings, past its first batch
            lcfg = defaults.clone()
            lcfg.merge_from_list(opts + ["SOLVER.MAX_ITER", "25"])
            n_batches = 0
            for _ in make_data_loader(lcfg, is_train=True):
                n_batches += 1
                if n_batches == 1:
                    t_first = time.perf_counter()
            loader_s = (time.perf_counter() - t_first) / (n_batches - 1)
            thr = {"s_per_iter_median": step_s, "s_per_iter_each": times,
                   "img_per_s": 8 / step_s, "data_time_share": sum(waits) / sum(times),
                   "data_time_share_after_first": sum(waits[1:]) / sum(times[1:]),
                   "data_s_each": waits, "wall_s": wall,
                   "loader_alone_s_per_batch": loader_s, "loader_alone_img_per_s": 8 / loader_s,
                   "make_train_step_img_per_s": step_throughput["img_per_s"], "card": card}
            print("entry point throughput: " + json.dumps(thr), flush=True)

            # 14. resume to 12 from model_final
            final = os.path.join(out, "model_final.pth")
            saved = torch.load(final, map_location="cpu", weights_only=True)
            check(saved["iteration"] == 8, "model_final holds iteration {}".format(
                saved["iteration"]))
            start = {}

            def recording(model, optimizer, *args, **kwargs):
                start.update((k, v.detach().cpu().clone()) for k, v in model.state_dict().items())
                return do_train(model, optimizer, *args, **kwargs)

            train_net.do_train = recording
            _, meters2 = train_net.main(["--skip-test"] + opts + ["SOLVER.MAX_ITER", "12"])
            torch.cuda.synchronize()
            resumed = any("Loading checkpoint from " + final in line for line in logs.lines)
            its2 = logged_iterations()
        check(resumed, "the resumed run did not load {}".format(final))
        check(its2 and min(its2) >= 9, "the resumed run logged iterations {}".format(its2))
        check(set(start) == set(saved["model"]) and all(
            torch.equal(start[k], v) for k, v in saved["model"].items()),
            "the resumed run did not start from the saved parameters")
        losses2 = {k: m.global_avg for k, m in meters2.meters.items() if k.startswith("loss")}
        check(all(math.isfinite(v) for v in losses2.values()), "resumed losses {}".format(losses2))
        print("entry point resume: loaded model_final (iteration 8), {} parameters and buffers "
              "equal to the saved ones, logged iterations {}, losses {}".format(
                  len(start), its2, json.dumps(losses2)), flush=True)
        return {"launches": launches}
    finally:
        COCODataset._load_image = load_image
        train_net.do_train = do_train
        for lg in loggers:
            lg.removeHandler(logs)
        shutil.rmtree(work, ignore_errors=True)


def profile_steps(torch, step, batch, steps=2):
    """Where a training step's device time goes (torch.profiler, CUPTI):
    per step under the profiler, the wall time, the summed time of the
    device's kernels and copies, the idle share, and the kernels with the
    most time. Informational: a profiler that sees no device time leaves
    its numbers as "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def self_device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                    key=self_device_us, reverse=True)
    busy_ms = sum(self_device_us(e) for e in events) / 1e3 / steps
    if busy_ms <= 0:
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured"}
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
        "top_kernels_ms": [[e.key[:90], self_device_us(e) / 1e3 / steps, e.count / steps]
                           for e in events[:15]],
        "roi_align_kernels_per_step": {e.key[:90]: e.count / steps for e in events
                                       if "roi_align" in e.key or "cast_to_bf16" in e.key},
        "memsets_per_step": sum(e.count for e in events if "memset" in e.key.lower()) / steps,
    }


def reference_check(torch, np, detector, cfg, state):
    """The model's weights in float32 on a small image: the card (kernels)
    against the CPU (plain versions)."""
    c = cfg.clone()
    c.TPU.COMPUTE_DTYPE = "float32"
    torch.backends.cudnn.allow_tf32 = False
    rs = np.random.RandomState(SEED + 1)
    batch = {"images": torch.from_numpy(rs.randint(0, 256, (1, 256, 320, 3)).astype(np.uint8)),
             "image_sizes": torch.tensor([[250, 310]], dtype=torch.int32)}
    outs, feats = [], []
    for dev in ("cuda", "cpu"):
        m = detector.GeneralizedRCNN(c)
        m.load_state_dict(state)
        m.to(dev).eval()
        b = {k: v.to(dev) for k, v in batch.items()}
        det = m.infer_forward(b)
        with torch.no_grad():
            x = m._prepare_images(b["images"], b["image_sizes"]).permute(0, 3, 1, 2)
            feats.append([f.cpu() for f in m.backbone(x.contiguous(memory_format=torch.channels_last))])
        valid = det["valid"][0].cpu()
        outs.append({k: det[k][0].cpu()[valid].numpy() for k in ("boxes", "scores", "labels", "masks")})
    check(len(outs[0]["scores"]) == len(outs[1]["scores"]) > 0,
          "card kept {} detections, CPU {}".format(len(outs[0]["scores"]), len(outs[1]["scores"])))
    return {
        "detections": len(outs[0]["scores"]),
        "agree": match_detections(outs[0], outs[1]),
        "feature_rel_err": max(((a - b).abs().max() / b.abs().max()).item()
                               for a, b in zip(*feats)),
        "sorted_score_err": float(np.abs(np.sort(outs[0]["scores"])
                                         - np.sort(outs[1]["scores"])).max()),
    }


# Gradients held card against CPU: the RPN head, P2's lateral and output
# convs (every ROI of a 64x96 image pools from P2), the box and mask heads.
# Deeper backbone weights are left out: at this image size their gradient
# reaches them only through the FPN's top-down sums of P2's, which largely
# cancel, so its rounding between card and CPU is magnified (PERF.md).
REF_GRADS = (
    "rpn.cls_logits.weight", "rpn.bbox_pred.weight", "rpn.conv.weight",
    "backbone.fpn.inner.0.conv.weight", "backbone.fpn.layer.0.conv.weight",
    "roi_heads.box.feature_extractor.fc6.weight", "roi_heads.box.predictor.cls_score.weight",
    "roi_heads.mask.predictor.conv5_mask.weight",
    "roi_heads.mask.predictor.mask_fcn_logits.weight",
)


def train_reference_check(torch, np, cfg, state, backwards):
    """One float32 forward and backward of the training losses on a small
    batch (2 images of 64x96) with the trained weights, on the card
    (kernels) and on the CPU (plain versions), with the same sampler draws.

    The discrete steps of the path would round apart on the two sides: the
    card and the CPU compute the objectness scores ~1e-6 apart, enough to
    swap near-equal proposals, and the proposals' ranks decide the greedy
    NMS order, the top-k cuts and which draw each proposal gets. So this
    check removes every rank-dependent decision while running the same
    code: the RPN box deltas are zeroed (the proposals are the anchors
    exactly), the NMS threshold is 1.0 (nothing is suppressed), no top-k
    cuts (pre- and post-NMS caps of the largest level's anchor count, a
    batch-wide cap of every anchor), and the box sampler takes every
    anchor and gt of an image (BATCH_SIZE_PER_IMAGE = anchors + gt slots,
    and as many mask ROIs), so every proposal is sampled whatever its rank.
    The matcher, NMS and
    ROIAlign kernels all run on the card side. The CPU side runs with
    oneDNN off: at these shapes its float32 convolutions lose percents of
    the gradient reaching P2 against a float64 run, PyTorch's own CPU
    convolutions about 1e-4 (PERF.md). Losses must agree to 1e-4 relative
    and the gradients in REF_GRADS to 1e-2 of their max (float32 sums over
    thousands of ROIs that largely cancel; PERF.md has the measured
    errors)."""
    from maskrcnn_tpu_torch.models import detector
    from maskrcnn_tpu_torch.ops.sampler import uniform_draws

    c = cfg.clone()
    c.TPU.COMPUTE_DTYPE = "float32"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = train_batch(torch, np, 2, (64, 96), (64, 96), 8, c.TPU.GT_MASK_SIZE, SEED + 1,
                        "cpu", block_masks=True)
    b, g = batch["gt_labels"].shape
    with torch.no_grad():
        per_level = [a.shape[0] for a in detector.GeneralizedRCNN(c)._backbone(batch)[1]]
    n = sum(per_level)
    r = c.MODEL.RPN
    r.PRE_NMS_TOP_N_TRAIN = r.POST_NMS_TOP_N_TRAIN = max(per_level)
    r.FPN_POST_NMS_TOP_N_TRAIN = b * n
    r.NMS_THRESH = 1.0
    c.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = c.TPU.MASK_ROI_CAP = n + g
    n_props = min(b * n, len(per_level) * max(per_level)) + g
    state = {k: v.detach().cpu() for k, v in state.items()}
    state["rpn.bbox_pred.weight"] = torch.zeros_like(state["rpn.bbox_pred.weight"])
    state["rpn.bbox_pred.bias"] = torch.zeros_like(state["rpn.bbox_pred.bias"])
    gen = torch.Generator().manual_seed(SEED)
    draws = {}
    draws["rpn_pos"], draws["rpn_neg"] = uniform_draws((b, n), gen, "cpu")
    draws["box_pos"], draws["box_neg"] = uniform_draws((b, n_props), gen, "cpu")
    out = {}
    for dev in ("cuda", "cpu"):
        m = detector.GeneralizedRCNN(c)
        m.load_state_dict(state)
        m.to(dev)
        mkldnn = torch.backends.mkldnn.enabled
        torch.backends.mkldnn.enabled = dev != "cpu"
        try:
            losses = m.train_forward({k: v.to(dev) for k, v in batch.items()},
                                     draws={k: v.to(dev) for k, v in draws.items()})
            sum(losses.values()).backward()
        finally:
            torch.backends.mkldnn.enabled = mkldnn
        out[dev] = ({k: v.item() for k, v in losses.items()},
                    {n: p.grad.cpu() for n, p in m.named_parameters() if n in REF_GRADS})
    (lc, gc), (lp, gp) = out["cuda"], out["cpu"]
    loss_err = {k: abs(lc[k] - lp[k]) / max(abs(lp[k]), 1e-12) for k in lp}
    grad_err = {k: ((gc[k] - gp[k]).abs().max() / gp[k].abs().max()).item() for k in gp}
    ref = {"backwards": backwards, "losses_card": lc, "losses_cpu": lp,
           "loss_rel_err": loss_err, "grad_rel_err": grad_err}
    print("float32 training step, card vs CPU: " + json.dumps(ref), flush=True)
    check(len(grad_err) == len(REF_GRADS), "missing gradients")
    check(all(v <= 1e-4 for v in loss_err.values()), "card and CPU losses differ")
    check(all(v <= 1e-2 for v in grad_err.values()), "card and CPU gradients differ")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "maskrcnn_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 1
    try:
        kind, count = run(torch)
    except SmokeError as e:
        print("chip_smoke FAILED: {}".format(e), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
