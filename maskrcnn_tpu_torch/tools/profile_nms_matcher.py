"""Where the NMS and anchor-matcher kernels spend their time on the main paths.

Run from the root of a checkout, with one CUDA card visible:

    python3 -m maskrcnn_tpu_torch.tools.profile_nms_matcher [--parent DIR] [--variant DIR ...]
        [--save FILE] [--timeline] [--rpn]

It builds the flagship as chip_smoke.py does (seeded weights, bf16 compute,
frozen-BN statistics from the input), serves one 480x640 request and takes
one training step at batch 8 of 800x1344, and keeps the inputs of the three
NMS calls (serving RPN 5 x 1000 at t=0.7, serving box post-process 80 x 200
at t=0.5, training RPN 40 x 2000 at t=0.7) and of the step's matcher call;
the training RPN's 40 lanes twice over make an 80 x 2000 site, the lanes of
a batch of 16.
For each it prints one JSON line with the kernel alone on prepared buffers
(CUDA events, ms per call) and the device time of each launch inside that
call (torch.profiler, ms per call, by kernel name).

With --parent DIR (an unpacked checkout of another commit) it also builds
that checkout's csrc/nms.cu and csrc/matcher.cu into build/profile/ and times
them on the same inputs, in turns with this checkout's (parent, this, this,
parent). --variant DIR does the same for another design of this
checkout's entry points (nms_keep, match_anchors) kept in DIR (given more
than once, for each; named by DIR's last component). --save FILE writes the
captured inputs (CPU tensors) with torch.save. --timeline also times the phases of the matcher's one launch
on the step's inputs: a copy of csrc/matcher.cu in build/profile/ in which
thread 0 of every block reads the global timer at each phase's end; it
prints, in microseconds from the first block's start, when the last block
ended each phase (staging, the first grid barrier, pass 1, the fold of the
block maxima, the second barrier, pass 2). --rpn times the same training
step with the RPN's per-level top-k taken three ways (torch.topk on every
level, a stable sort on every level, and rpn.top_k_fast, the JAX package's
choice by size), in turns, with what rpn's select_proposals takes of the
step's device time (chip_smoke.function_shares).
"""

import ctypes
import functools
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _other_libs(native, root, tag):
    """Another checkout's nms.cu and matcher.cu, built into build/profile/."""
    out_dir = os.path.join(REPO, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name in ("nms", "matcher"):
        src = os.path.join(root, "maskrcnn_tpu_torch", "csrc", name + ".cu")
        lib = os.path.join(out_dir, "lib{}_{}.so".format(tag, name))
        jobs[name] = (lib, subprocess.Popen([native.nvcc_path(), *native.NVCC_FLAGS, "-o", lib, src],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("building {} {} failed:\n{}".format(tag, name, out.decode()[-4000:]))
        libs[name] = ctypes.CDLL(lib)
    return libs


# (anchor in csrc/matcher.cu, mark put after it): the phase ends
_TIMELINE = (
    ("  cg::grid_group grid = cg::this_grid();\n", 0),
    ("      if (v) atomicMax(&s_ng[e / g], e % g + 1);\n    }\n", 1),
    ("    grid.sync();  // best zeroed; the previous group's restore done\n", 2),
    ("          if (i < n) out[(size_t)(b0 + k) * n + i] = bv[u] < low ? -1 : (bv[u] < high ? -2 : bi[u]);\n"
     "        }\n      }\n    }\n", 3),
    ("      if (s.best[e] > 0u) atomicMax(&best[(size_t)b0 * g + e], s.best[e]);\n    }\n", 4),
    ("    grid.sync();  // every block's maxima folded into best\n", 5),
    ("    __syncthreads();  // before the next group restages the slots\n", 6),
)
PHASES = ("staged", "barrier_1", "pass_1", "folded", "barrier_2", "pass_2")


@functools.lru_cache(maxsize=None)
def _timeline_lib(native):
    src = open(os.path.join(REPO, "maskrcnn_tpu_torch", "csrc", "matcher.cu")).read()
    for anchor, i in _TIMELINE:
        if src.count(anchor) != 1:
            raise RuntimeError("timeline anchor not found once: " + anchor.strip())
        src = src.replace(anchor, anchor + "  TL_MARK({});\n".format(i))
    prelude = ("__device__ unsigned long long g_tl[8];\n"
               "#define TL_MARK(i) if (threadIdx.x == 0) { unsigned long long now; "
               "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(now)); "
               "if (i == 0) atomicMin(&g_tl[7], now); atomicMax(&g_tl[i], now); }\n")
    tail = ('\nextern "C" int timeline_read(unsigned long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, g_tl, sizeof(g_tl));\n}\n"
            'extern "C" int timeline_zero() {\n  unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, ~0ull};\n'
            "  return (int)cudaMemcpyToSymbol(g_tl, z, sizeof(z));\n}\n")
    out_dir = os.path.join(REPO, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "timeline_matcher.cu")
    with open(path, "w") as f:
        f.write(prelude + src + tail)
    lib = os.path.join(out_dir, "libtimeline_matcher.so")
    proc = subprocess.run([native.nvcc_path(), *native.NVCC_FLAGS, "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError("building the timeline copy failed:\n" + proc.stdout[-4000:])
    return ctypes.CDLL(lib)


def matcher_timeline(native, matcher, anchors, gt, valid, high, low, runs=5):
    """{phase: microseconds from the first block's start to the last block's
    end of that phase}, the median of `runs` launches of the instrumented copy."""
    lib = _timeline_lib(native)
    saved = native._LIBS["matcher"]
    lib._typed = False
    native._LIBS["matcher"] = lib
    try:
        run, _ = current_matcher(matcher, anchors, gt, valid, high, low)
        marks = []
        for _ in range(runs):
            lib.timeline_zero()
            run()
            torch.cuda.synchronize()
            tl = (ctypes.c_ulonglong * 8)()
            lib.timeline_read(tl)
            marks.append([(tl[i] - tl[7]) / 1e3 for i in range(1, 7)])
    finally:
        native._LIBS["matcher"] = saved
    return {name: float(np.median([m[k] for m in marks])) for k, name in enumerate(PHASES)}


def parent_nms(lib, nms, boxes, scores, valid, thresh):
    """A closure launching the earlier design's NMS (mask + reduce, the
    entry point nms_keep_sorted) alone on prepared buffers."""
    lib.nms_keep_sorted.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                                            ctypes.c_float, ctypes.c_void_p]
    order, sboxes, svalid = nms._sort_lanes(boxes, scores, valid)
    g, n = scores.shape
    sboxes, su8 = sboxes.contiguous(), svalid.to(torch.uint8).contiguous()
    mask = torch.empty((g, n, (n + 63) // 64), dtype=torch.int64, device=boxes.device)
    keep = torch.empty((g, n), dtype=torch.uint8, device=boxes.device)

    def run():
        rc = lib.nms_keep_sorted(sboxes.data_ptr(), su8.data_ptr(), mask.data_ptr(),
                                 keep.data_ptr(), g, n, float(thresh),
                                 torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("parent nms failed: CUDA error {}".format(rc))

    def result():
        return torch.zeros_like(valid).scatter_(1, order, keep.bool())

    return run, result


def parent_matcher(lib, anchors, gt, valid, high, low):
    """A closure launching the parent design's matcher (memset + two
    launches, entry point match_anchors) alone on prepared buffers."""
    lib.match_anchors.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_float] + [ctypes.c_void_p] * 3
    b, g = valid.shape
    n = anchors.shape[0]
    v8 = valid.to(torch.uint8).contiguous()
    best = torch.empty((b, max(g, 1)), dtype=torch.int32, device=anchors.device)
    out = torch.empty((b, n), dtype=torch.int32, device=anchors.device)

    def run():
        rc = lib.match_anchors(anchors.data_ptr(), gt.data_ptr(), v8.data_ptr(), n, b, g,
                               float(high), float(low), best.data_ptr(), out.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError("parent matcher failed: CUDA error {}".format(rc))

    return run, lambda: out


def _swapped(native, name, lib, fn):
    """fn run with library `name` replaced by `lib`."""
    def run():
        saved = native._LIBS[name]
        native._LIBS[name] = lib
        try:
            return fn()
        finally:
            native._LIBS[name] = saved
    return run


def variant(native, name, lib, make, *args):
    """A (run, result) pair like make's, launching `lib`'s kernel."""
    run, result = _swapped(native, name, lib, lambda: make(*args))()
    return _swapped(native, name, lib, run), result


def current_nms(nms, boxes, scores, valid, thresh):
    """A closure launching this checkout's NMS kernel alone on prepared
    buffers, and one returning its keep-mask (original order)."""
    prepared = nms.prepare(boxes, scores, valid)
    keep = torch.empty(valid.shape, dtype=torch.bool, device=boxes.device)
    return (lambda: nms.launch(*prepared, keep, thresh)), (lambda: keep)


def current_matcher(matcher, anchors, gt, valid, high, low):
    b, g = valid.shape
    best = torch.empty((b, max(g, 1)), dtype=torch.int32, device=anchors.device)
    out = torch.empty((b, anchors.shape[0]), dtype=torch.int32, device=anchors.device)
    return (lambda: matcher.launch(anchors, gt, valid, high, low, best, out)), (lambda: out)


def flagship_training(cs):
    """The flagship's training step at batch 8 of 800x1344 (bf16, seeded
    weights, frozen-BN statistics from the input), as chip_smoke.py builds
    it: (step, batch)."""
    from maskrcnn_tpu_torch.config import flagship_cfg
    from maskrcnn_tpu_torch.engine import make_train_step
    from maskrcnn_tpu_torch.models import build_detection_model
    from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer

    cfg = flagship_cfg()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    model = build_detection_model(cfg, device="cuda", seed=cs.SEED)
    batch = cs.train_batch(torch, np, cs.TRAIN_BATCH, cs.TRAIN_HW, cs.TRAIN_SIZE,
                           cfg.TPU.MAX_GT_BOXES, cfg.TPU.GT_MASK_SIZE, cs.SEED, "cuda")
    cs.calibrate_frozen_bn(torch, model, batch["images"])
    opt = make_optimizer(cfg, model)
    step = make_train_step(model, opt, make_lr_scheduler(cfg, opt),
                           generator=torch.Generator(device="cuda").manual_seed(cs.SEED))
    return step, batch


def capture_sites(cs):
    """The inputs of the serving request's two NMS calls and of one training
    step's NMS and matcher calls, as chip_smoke.py drives them."""
    from maskrcnn_tpu_torch.config import flagship_cfg
    from maskrcnn_tpu_torch.models import rpn
    from maskrcnn_tpu_torch.models.roi_heads import box_head
    from maskrcnn_tpu_torch.predictor import Predictor

    cfg = flagship_cfg()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.MODEL.ROI_HEADS.SCORE_THRESH = 0.0
    rs = np.random.RandomState(cs.SEED)
    warm = rs.randint(0, 256, (480, 640, 3)).astype(np.uint8)
    pred = Predictor(cfg, device="cuda", seed=cs.SEED,
                     min_image_size=cfg.INPUT.MIN_SIZE_TEST)
    cs.calibrate_frozen_bn(torch, pred.model, pred.preprocess(warm)[0])
    pred.compute_prediction(warm)
    with cs.Capture([rpn, box_head], "batched_nms") as serve_nms:
        pred.compute_prediction(warm)
    del pred
    torch.cuda.empty_cache()

    step, batch = flagship_training(cs)
    step(batch)
    with cs.Capture([rpn], "batched_nms") as train_nms, \
            cs.Capture([rpn], "match_anchors_batched") as train_match:
        step(batch)
    torch.cuda.synchronize()
    del step, batch
    torch.cuda.empty_cache()
    names = ("serving_rpn", "serving_box", "training_rpn")
    sites = {k: tuple(t.detach() if torch.is_tensor(t) else t for t in call)
             for k, call in zip(names, serve_nms.calls + train_nms.calls)}
    boxes, scores, valid, thresh = sites["training_rpn"]
    sites["training_rpn_x2"] = (torch.cat([boxes] * 2), torch.cat([scores] * 2),
                                torch.cat([valid] * 2), thresh)
    sites["matcher"] = tuple(t.detach() if torch.is_tensor(t) else t
                             for t in train_match.calls[0])
    return sites


def rpn_topk(cs, card, steps=3):
    """The flagship's training step with the RPN's per-level top-k taken
    three ways, in turns (topk, stable, by_size, by_size, stable, topk):
    one JSON line of each way's wall ms, device busy and select_proposals
    share a step (torch.profiler over `steps` steps, after one warm step)."""
    from maskrcnn_tpu_torch.models import detector, rpn

    step, batch = flagship_training(cs)
    step(batch)
    plain = rpn.top_k_fast
    ways = {"topk": lambda x, k: torch.topk(x, k, dim=-1), "stable": rpn.top_k_stable,
            "by_size": plain}
    res = {"site": "rpn_top_k", "batch": list(batch["images"].shape), "card": card}
    for way in ("topk", "stable", "by_size", "by_size", "stable", "topk"):
        rpn.top_k_fast = ways[way]
        try:
            step(batch)
            got = cs.function_shares(torch, {"select_proposals": (detector, "select_proposals")},
                                     step, batch, steps)
        finally:
            rpn.top_k_fast = plain
        res.setdefault(way, []).append(
            {"wall_ms": got["wall_ms"], "device_busy_ms": got["device_busy_ms"],
             "select_proposals_ms": got["select_proposals"].get("ms", "not measured")})
    print(json.dumps(res), flush=True)
    del step, batch
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        print("profile_nms_matcher: no CUDA device", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    parent = args[args.index("--parent") + 1] if "--parent" in args else None
    save = args[args.index("--save") + 1] if "--save" in args else None
    timeline = "--timeline" in args
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    from maskrcnn_tpu_torch.ops import matcher, native, nms

    native.build(("nms", "matcher"))
    parents = _other_libs(native, parent, "parent") if parent else {}
    variants = {"variant:" + os.path.basename(os.path.normpath(d)): _other_libs(
        native, d, "variant_" + os.path.basename(os.path.normpath(d)))
        for d in (args[i + 1] for i, a in enumerate(args) if a == "--variant")}
    card = cs.card_line()
    print("card:", card, flush=True)
    if "--rpn" in args:
        rpn_topk(cs, card)
    sites = capture_sites(cs)
    if save:
        os.makedirs(os.path.dirname(os.path.abspath(save)), exist_ok=True)
        torch.save({k: tuple(t.cpu() if torch.is_tensor(t) else t for t in v)
                    for k, v in sites.items()}, save)

    for name, args_ in sites.items():
        if name == "matcher":
            want = matcher.match_anchors_plain(*args_)
            designs = {"this": current_matcher(matcher, *args_)}
            if parents:
                designs["parent"] = parent_matcher(parents["matcher"], *args_)
            for tag, libs in variants.items():
                designs[tag] = variant(native, "matcher", libs["matcher"], current_matcher,
                                       matcher, *args_)
            res = {"site": name, "anchors": args_[0].shape[0], "gt": list(args_[1].shape[:2]),
                   "valid_gt": int(args_[2].sum())}
        else:
            boxes, scores, valid, thresh = args_
            want = nms.batched_nms_plain(boxes, scores, valid, thresh)
            designs = {"this": current_nms(nms, *args_)}
            if parents:
                designs["parent"] = parent_nms(parents["nms"], nms, *args_)
            for tag, libs in variants.items():
                designs[tag] = variant(native, "nms", libs["nms"], current_nms, nms, *args_)
            res = {"site": name, "lanes": list(scores.shape), "iou_threshold": thresh,
                   "kept": int(want.sum())}
        others = [d for d in designs if d != "this"]
        for d in others + ["this", "this"] + others[::-1]:
            run, result = designs[d]
            ms = cs.cuda_ms(torch, run, 50)
            res.setdefault(d + "_kernel_ms", []).append(ms)
        for d, (run, result) in designs.items():
            run()
            torch.cuda.synchronize()
            res[d + "_exact"] = bool(torch.equal(result(), want))
            res[d + "_launch_ms"] = cs.launch_ms(torch, run)
        if name == "matcher" and timeline:
            res["timeline_us"] = matcher_timeline(native, matcher, *args_)
        res["card"] = card
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
