#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (maskrcnn_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases; any failure exits non-zero and prints no result line:
  1. the card's name and power limit (nvidia-smi); every CUDA kernel of the
     serving path built from maskrcnn_tpu_torch/csrc by nvcc, one process
     per source, all started together;
  2. the flagship Mask R-CNN R-50-FPN at full width from the port's seeded
     init, bfloat16 compute. ROI_HEADS.SCORE_THRESH is lowered to 0: random
     weights give near-uniform class scores below the default 0.05, and the
     mask head should pool real boxes;
  3. four requests of COCO-like sizes after one warm-up, through
     Predictor.compute_prediction, each with its latency;
  4. the launch counts of that run: NMS twice and ROIAlign twice a request;
  5. each kernel against its plain PyTorch version on the inputs the main
     path fed it in the first request, timed with CUDA events beside the
     least time the card could take for the same work;
  6. the outputs: finite and of the expected shapes, and the same weights in
     float32 on a small image agreeing between the card (kernels) and the
     CPU (plain versions).
Then one JSON line of kernels, the card's line, and the result line.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
REQUEST_SIZES = ((480, 640), (427, 640), (640, 480), (375, 500))
SEED = 0
# Published H100 SXM peaks at 700 W: HBM bandwidth, and float32 arithmetic
# outside the tensor cores (both kernels run on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# arithmetic per IoU test (min/max/sub/add/clamp per side, product, union,
# division, comparison) and per ROIAlign sample and channel (4 products,
# 3 sums, 1 accumulate)
NMS_OPS_PER_PAIR = 15
ROI_OPS_PER_SAMPLE = 8


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
    call it (the module attribute `name`), while active."""

    def __init__(self, modules, name):
        self.modules, self.name, self.calls = modules, name, []

    def __enter__(self):
        self.saved = [getattr(m, self.name) for m in self.modules]
        for m, fn in zip(self.modules, self.saved):
            setattr(m, self.name, self._recording(fn))
        return self

    def _recording(self, fn):
        def wrapper(*args):
            self.calls.append(args)
            return fn(*args)
        return wrapper

    def __exit__(self, *exc):
        for m, fn in zip(self.modules, self.saved):
            setattr(m, self.name, fn)


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
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).contiguous()
    su8 = svalid.to(torch.uint8).contiguous()
    scratch = torch.empty((g, n, (n + 63) // 64), dtype=torch.int64, device=boxes.device)
    keep = torch.empty((g, n), dtype=torch.uint8, device=boxes.device)
    nbytes = g * n * (16 + 4 + 1) + g * n  # boxes, scores, valid in; keep out
    b_ms, b_by = bound(nbytes, NMS_OPS_PER_PAIR * pairs)
    return {
        "shape": [g, n], "iou_threshold": thresh, "kept": int(want.sum()),
        "max_abs_err": float((got != want).sum()),
        "ms": cuda_ms(torch, lambda: nms.batched_nms(boxes, scores, valid, thresh), 50),
        "kernel_ms": cuda_ms(torch, lambda: nms.launch_sorted(sboxes, su8, scratch, keep, thresh), 50),
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


def kernel_entry(name, source, replaces, launches, sites):
    """One kernel's line entry: times are means per launch over the main
    path's call sites (one launch each per request); sites has each."""
    mean = lambda k: sum(s[k] for s in sites) / len(sites)  # noqa: E731
    by = [s["bound_by"] for s in sites]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max(s["max_abs_err"] for s in sites),
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
    from maskrcnn_tpu_torch.ops import native, nms
    from maskrcnn_tpu_torch.predictor import Predictor

    # 1. card and build
    card = card_line()
    print("card:", card, flush=True)
    t0 = time.perf_counter()
    logs = native.build()
    print("built {} with nvcc in {:.1f} s ({})".format(
        ", ".join(native.KERNELS), time.perf_counter() - t0,
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

    nms.batched_nms.launches = 0
    poolers.multilevel_roi_align.launches = 0
    with Capture([rpn, box_head], "batched_nms") as nms_cap, \
            Capture([detector], "multilevel_roi_align") as roi_cap:
        serve(images[0])
    for img in images[1:]:
        serve(img)
    n_nms = nms.batched_nms.launches
    n_roi = poolers.multilevel_roi_align.launches

    # 4. launch counts of the main path
    print("launches in {} requests: nms {}, roi_align {}".format(len(images), n_nms, n_roi))
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

    kernels = [
        kernel_entry("nms", "maskrcnn_tpu_torch/csrc/nms.cu",
                     "maskrcnn_tpu/ops/pallas/nms_kernel.py:161", n_nms, nms_sites),
        kernel_entry("roi_align", "maskrcnn_tpu_torch/csrc/roi_align.cu",
                     "maskrcnn_tpu/ops/pallas/roi_align_kernel.py:434", n_roi, roi_sites),
    ]
    print("latency ms per request: " + json.dumps(latencies)
          + "; second pass: " + json.dumps(seen))
    print(json.dumps({"kernels": kernels}))
    print(card)
    return torch.cuda.get_device_name(0), torch.cuda.device_count()


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
