"""Where the "roi" ROIAlign backward spends its time on the training step.

Run from the root of a checkout, with one CUDA card visible:

    python3 -m maskrcnn_tpu_torch.tools.profile_roi_backward

It builds the flagship training step as chip_smoke.py does (batch 8 of
800x1344, bf16 compute, seeded weights, frozen-BN statistics from the batch),
takes one step, keeps the ROIs and the gradient that reach each pooler, and
prints one JSON line per pooler with
  * the kernel alone (csrc/roi_align.cu:roi_align_backward) on every ROI, on
    the ROIs of the busiest tile only, on those of the 20 busiest tiles, on
    the others, and with every ROI moved off the map (each block then only
    scans its ROI list), in ms (CUDA events);
  * for the blocks of the tiles that 100 ROIs or more meet, the mean clock
    cycles thread 0 spends in each phase of roi_align_bwd_tile_kernel: the
    scan, the weights and bin ranges, the cut of a run of ROIs, the dOut
    staging and the sums.
    They come from a copy of the source with clock64() counters, built into
    build/profile/ beside the real library and used for that one launch.
With --layouts it also times the kernel built with other channel slices
(kSlice) and warps per block (kWarps), copies of the source in
build/profile/ with those constants replaced, each twice in turns.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PHASES = ("scan", "weights_and_ranges", "run_cut", "stage", "sums")
# (anchor in the kernel's source, code put before it, code put after it):
# thread 0 of each block adds the cycles since the previous mark to a phase
_MARKS = (
    ("  const int seg = l * nb + b;\n", "",
     "  long long prof[5] = {0, 0, 0, 0, 0}, mark = clock64();\n  int prof_hits = 0;\n"),
    ("      s_geom[k] = roi_geom(box, scale, p, s);\n    }\n    __syncthreads();\n", "",
     "    prof_hits += nhit;\n    PROF_MARK(0);\n"),
    ("      // the hits in runs whose dOut bins fit the stage.", "      PROF_MARK(1);\n", ""),
    ("        const int staged = __shfl_sync(kFull, incl, run - 1);\n", "", "        PROF_MARK(2);\n"),
    ("        cp_async_wait_all();\n        __syncthreads();\n", "", "        PROF_MARK(3);\n"),
    ("        __syncthreads();  // before the next run restages\n", "", "        PROF_MARK(4);\n"),
    ("  if (x0 + x < w && ch < c) {\n    T* g",
     "  if (threadIdx.x == 0 && prof_hits >= 100) {\n"
     "    for (int i = 0; i < 5; ++i) atomicAdd(&g_prof[i], (unsigned long long)prof[i]);\n"
     "    atomicAdd(&g_prof[5], 1ull);\n"
     "    atomicAdd(&g_prof[6], (unsigned long long)prof_hits);\n  }\n", ""),
)


def _instrumented_source():
    src = open(os.path.join(REPO, "maskrcnn_tpu_torch", "csrc", "roi_align.cu")).read()
    head, body = src.split("roi_align_bwd_tile_kernel(TileLevels", 1)
    for anchor, before, after in _MARKS:
        if body.count(anchor) != 1:
            raise RuntimeError("profile anchor not found once: " + anchor.strip())
        body = body.replace(anchor, before + anchor + after)
    prelude = ("__device__ unsigned long long g_prof[7];\n"
               "#define PROF_MARK(i) if (threadIdx.x == 0) { const long long now = clock64(); "
               "prof[i] += now - mark; mark = now; }\n")
    tail = ('\nextern "C" int profile_read(unsigned long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n}\n"
            'extern "C" int profile_zero() {\n  unsigned long long z[7] = {0};\n'
            "  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n}\n")
    return prelude + head + "roi_align_bwd_tile_kernel(TileLevels" + body + tail


# the other layouts --layouts builds: (kSlice, kWarps)
LAYOUTS = ((32, 8), (64, 8), (128, 8), (256, 8), (128, 16), (128, 32))


def _build_variants(native, sources):
    """Build {name: CUDA source} into build/profile/, all at once; returns
    {name: ctypes library}."""
    out_dir = os.path.join(REPO, "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name, text in sources.items():
        src = os.path.join(out_dir, name + ".cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, "lib" + name + ".so")
        jobs[name] = (lib, subprocess.Popen([native.nvcc_path(), *native.NVCC_FLAGS, "-o", lib, src],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError("building {} failed:\n{}".format(name, out.decode()[-4000:]))
        libs[name] = ctypes.CDLL(lib)
    return libs


def _layout_source(slice_, warps):
    src = open(os.path.join(REPO, "maskrcnn_tpu_torch", "csrc", "roi_align.cu")).read()
    for old, new in (("constexpr int kSlice = ", "constexpr int kSlice = %d;" % slice_),
                     ("constexpr int kWarps = ", "constexpr int kWarps = %d;" % warps)):
        line = next(x for x in src.splitlines() if x.startswith(old))
        src = src.replace(line, new + "  //" + line.split("//", 1)[-1])
    return src


def main():
    if not torch.cuda.is_available():
        print("profile_roi_backward: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    from maskrcnn_tpu_torch.config import flagship_cfg
    from maskrcnn_tpu_torch.engine import make_train_step
    from maskrcnn_tpu_torch.models import build_detection_model, detector, poolers
    from maskrcnn_tpu_torch.ops import native
    from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer

    native.build(native.KERNELS)
    sources = {"profiled": _instrumented_source()}
    if "--layouts" in sys.argv[1:]:
        sources.update({"s%d_w%d" % lw: _layout_source(*lw) for lw in LAYOUTS})
    variants = _build_variants(native, sources)
    profiled = variants.pop("profiled")
    print("card:", cs.card_line(), flush=True)
    cfg = flagship_cfg()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    model = build_detection_model(cfg, device="cuda", seed=cs.SEED)
    batch = cs.train_batch(torch, np, cs.TRAIN_BATCH, cs.TRAIN_HW, cs.TRAIN_SIZE,
                           cfg.TPU.MAX_GT_BOXES, cfg.TPU.GT_MASK_SIZE, cs.SEED, "cuda")
    cs.calibrate_frozen_bn(torch, model, batch["images"])
    opt = make_optimizer(cfg, model)
    step = make_train_step(model, opt, make_lr_scheduler(cfg, opt),
                           generator=torch.Generator(device="cuda").manual_seed(cs.SEED))
    step(batch)
    with cs.Capture([detector], "multilevel_roi_align", grads=True) as cap:
        step(batch)
    torch.cuda.synchronize()

    for i, call in enumerate(cap.calls):
        shapes = [tuple(f.shape) for f in call[0]]
        boxes, bidx, pcfg = call[1].detach().contiguous(), call[2].int().contiguous(), call[3]
        dout = cap.out_grads[i].contiguous()
        lvl = poolers.assign_levels(boxes, pcfg).contiguous()
        out = torch.empty(sum(int(np.prod(s)) for s in shapes), dtype=dout.dtype, device="cuda")
        lists = poolers.tile_lists(shapes, boxes.cpu(), bidx.cpu(), lvl.cpu(), pcfg)
        busiest = sorted(lists, key=lambda k: -len(lists[k]))

        def rois_of(keys):
            mask = torch.zeros(len(boxes), dtype=torch.bool, device="cuda")
            for k in keys:
                mask[lists[k]] = True
            return mask

        def kernel_ms(mask=None, bx=boxes):
            mask = torch.ones(len(boxes), dtype=torch.bool, device="cuda") if mask is None else mask
            args = (bx[mask].contiguous(), bidx[mask].contiguous(), lvl[mask].contiguous())
            d = dout[mask].contiguous()
            inputs = poolers.roi_tile_inputs(shapes, args[1], args[2])
            return cs.cuda_ms(torch, lambda: poolers.launch_backward(
                shapes, *args, pcfg, d, None, out, "roi", inputs), 20)

        top20 = rois_of(busiest[:20])
        far = boxes.clone()
        far[:, [0, 2]] += 1e5
        res = {"P": pcfg.output_size, "rois": len(boxes), "all_ms": kernel_ms(),
               "busiest_tile_rois": len(lists[busiest[0]]),
               "busiest_tile_rois_only_ms": kernel_ms(rois_of(busiest[:1])),
               "top20_tiles_rois": int(top20.sum()), "top20_tiles_rois_only_ms": kernel_ms(top20),
               "all_but_top20_ms": kernel_ms(~top20), "scan_only_ms": kernel_ms(bx=far)}
        saved = native._LIBS["roi_align"]
        native._LIBS["roi_align"] = profiled
        try:
            profiled.profile_zero()
            poolers.launch_backward(shapes, boxes, bidx, lvl, pcfg, dout, None, out, "roi",
                                    poolers.roi_tile_inputs(shapes, bidx, lvl))
            torch.cuda.synchronize()
            counts = (ctypes.c_ulonglong * 7)()
            profiled.profile_read(counts)
        finally:
            native._LIBS["roi_align"] = saved
        blocks = max(counts[5], 1)
        res["blocks_of_tiles_met_by_100_rois_or_more"] = counts[5]
        res["their_mean_rois"] = counts[6] / blocks
        res["their_mean_cycles"] = {n: counts[k] / blocks for k, n in enumerate(PHASES)}
        for rnd in range(2):
            for name, lib in variants.items():
                native._LIBS["roi_align"] = lib
                try:
                    res.setdefault("layouts_ms", {}).setdefault(name, []).append(kernel_ms())
                finally:
                    native._LIBS["roi_align"] = saved
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
