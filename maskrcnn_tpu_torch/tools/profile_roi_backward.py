"""Where the ROIAlign backwards spend their time on the training step.

Run from the root of a checkout, with one CUDA card visible:

    python3 -m maskrcnn_tpu_torch.tools.profile_roi_backward [--kind roi|rmw|chunk]

It builds the flagship training step as chip_smoke.py does (batch 8 of
800x1344, bf16 compute, seeded weights, frozen-BN statistics from the batch),
takes one step, keeps the ROIs and the gradient that reach each pooler, and
prints one JSON line per pooler.

With --kind rmw or chunk, for that window backward: the wrapper
(poolers.BACKWARD_KERNELS[kind]) by CUDA events; each device launch of one
wrapper call by torch.profiler (ms per call and launches per call), split
into the backward's own (the roi_align kernels, memsets and casts) and the
layout's (PyTorch's small kernels); the layout alone (window_layout, and
window_kernel_inputs, what the wrapper hands the kernel) by CUDA events, by
the host clock and by its PyTorch operators on the host; and how the ROIs
load the gradient's 8 x 8 tiles: the ROIs whose footprint meets a tile, the
rows of the (at most 36) windows whose 48 x 48 cells cover it, and the ROIs
of its (level, image) that the "roi" backward scans.

With --kind roi (the default), for the "roi" backward:
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

For every kind, the kernel alone on every ROI, with the ROIs moved off the
map after their lists were built (finding and testing the candidates
only), and with no ROI (writing zeros only); with --variant DIR (any
number of times), also the kernel built from DIR's
maskrcnn_tpu_torch/csrc/roi_align.cu (the same C interface: another design
of this tree) on every ROI, in turns with this tree's. ptxas's registers
and spills of each roi_align entry function are printed first.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PHASES = ("scan", "weights_and_ranges", "run_cut", "stage", "sums")
# (anchor in the kernel's source, code put before it, code put after it):
# thread 0 of each block adds the cycles since the previous mark to a phase
_MARKS = (
    ("  const int seg = l * nb + b;\n", "",
     "  long long prof[5] = {0, 0, 0, 0, 0}, mark = clock64();\n  int prof_hits = 0;\n"),
    ("      s_geom[k] = roi_geom<kAdaptive>(box, scale, p, s);\n    }\n    __syncthreads();\n",
     "", "    prof_hits += nhit;\n    PROF_MARK(0);\n"),
    ("        // the hits in runs whose dOut bins fit the stage.", "        PROF_MARK(1);\n", ""),
    ("          const int staged = __shfl_sync(kFull, incl, run - 1);\n", "",
     "          PROF_MARK(2);\n"),
    ("          cp_async_wait_all();\n          __syncthreads();\n", "", "          PROF_MARK(3);\n"),
    ("          k0 += run;\n        }\n      }\n      if (tensor) {", "          PROF_MARK(4);\n", ""),
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


def _device_launches(fn, iters=20):
    """{device kernel or memset name: [ms per call, launches per call]} of
    fn() under torch.profiler (empty where it sees no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def self_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0].strip()[:70]:
            [self_us(e) / 1e3 / iters, e.count / iters] for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and self_us(e) > 0}


def _is_backward_launch(name):
    """The backward's own launches: its kernels, memsets and casts; the rest
    of a wrapper call is the layout's PyTorch work."""
    return "roi_align" in name or "memset" in name.lower() or "cast_to_bf16" in name


def _host_ops(fn, iters=20, top=10):
    """The PyTorch operators of fn() on the host (torch.profiler, CPU):
    operators per call, and the `top` with the most self time, [us per
    call, calls per call]."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    events.sort(key=lambda e: -e.self_cpu_time_total)
    return {"ops_per_call": sum(e.count for e in events) / iters,
            "top": {e.key: [e.self_cpu_time_total / iters, e.count / iters] for e in events[:top]}}


def _host_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def tile_load(poolers, shapes, boxes, bidx, lvl, pcfg):
    """How the ROIs load the 8 x 8 tiles of the gradient: per tile that an
    ROI's footprint meets, those ROIs (tile_lists), the rows of the windows
    whose cells cover the tile (window origins in [ty - 5, ty] x [tx - 5, tx]
    in 8-cell units), and the ROIs of its (level, image) segment."""
    boxes, bidx, lvl = boxes.cpu(), bidx.cpu(), lvl.cpu()
    lay = poolers.window_layout(shapes, boxes, bidx, lvl, pcfg)
    r = boxes.shape[0]
    nb = shapes[0][0]
    grids = {}
    for l, b, y0, x0 in zip(*(lay[k][:r].tolist() for k in ("lvl", "b", "y0", "x0"))):
        g = grids.setdefault((l, b), torch.zeros(-(-shapes[l][1] // 8), -(-shapes[l][2] // 8)))
        g[y0 // 8, x0 // 8] += 1
    seg = torch.bincount(lvl.long() * nb + bidx.long(), minlength=len(shapes) * nb).tolist()
    hits, cands, scans = [], [], []
    for (l, b, ty, tx), rois in poolers.tile_lists(shapes, boxes, bidx, lvl, pcfg).items():
        g = grids.get((l, b))
        hits.append(len(rois))
        cands.append(0 if g is None else int(g[max(ty - 5, 0):ty + 1, max(tx - 5, 0):tx + 1].sum()))
        scans.append(seg[l * nb + b])

    def stats(v):
        return {"max": max(v, default=0), "mean": sum(v) / max(len(v), 1), "sum": sum(v)}

    return {"tiles_met": len(hits), "rois_meeting_a_tile": stats(hits),
            "window_rows_covering_a_tile": stats(cands), "segment_rois_scanned": stats(scans),
            "windows": len(set(lay["rwid"][:r].tolist())), "oversize": int(lay["oversize"].sum())}


def kernel_phases(cs, native, poolers, kind, shapes, boxes, bidx, pcfg, dout, variants):
    """The backward kernel of `kind` alone (CUDA events), ms: on every ROI;
    with every ROI moved off the map after its inputs were built (the
    blocks then find their candidates and test them, but add nothing);
    with no ROI (the blocks only write zeros); and, in turns, the kernel
    built from each variant source ({name: ctypes library}) on every ROI."""
    lvl = poolers.assign_levels(boxes, pcfg).contiguous()
    out = torch.empty(sum(int(np.prod(sh)) for sh in shapes), dtype=dout.dtype, device="cuda")

    def inputs(b, i, lv):
        if kind == "roi":
            return poolers.roi_tile_inputs(shapes, i, lv)
        return poolers.window_kernel_inputs(kind, shapes, b, i, lv, pcfg)

    def ms(b, i, lv, d):
        got = inputs(b, i, lv)
        return cs.cuda_ms(torch, lambda: poolers.launch_backward(shapes, b, pcfg, d, out, kind,
                                                                 got), 20)

    far = boxes.clone()
    far[:, [0, 2]] += 1e5
    res = {"all_ms": ms(boxes, bidx, lvl, dout)}
    got = inputs(boxes, bidx, lvl)
    res["no_hits_ms"] = cs.cuda_ms(torch, lambda: poolers.launch_backward(
        shapes, far, pcfg, dout, out, kind, got), 20)
    res["no_rois_ms"] = ms(boxes[:0], bidx[:0], lvl[:0], dout[:0])
    saved = native._LIBS["roi_align"]
    for _ in range(2):
        for name, lib in [("this", saved)] + list(variants.items()):
            native._LIBS["roi_align"] = lib
            try:
                res.setdefault("variants_ms", {}).setdefault(name, []).append(
                    cs.cuda_ms(torch, lambda: poolers.launch_backward(
                        shapes, boxes, pcfg, dout, out, kind, got), 20))
            finally:
                native._LIBS["roi_align"] = saved
    return res


def register_report(log):
    """{kernel entry: "registers, spills"} from ptxas's -v output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = out.get(name, "") + m.group(1) + " registers"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name] = out.get(name, "") + ", spills {}/{} bytes; ".format(*m.groups())
    return out


def window_split(cs, poolers, kind, shapes, boxes, bidx, pcfg, dout):
    """The --kind rmw|chunk line of one pooler."""
    lvl = poolers.assign_levels(boxes, pcfg).contiguous()
    wrapper = poolers.BACKWARD_KERNELS[kind]

    def run():
        return wrapper(dout, shapes, boxes, bidx, lvl, pcfg)

    def layout():
        return poolers.window_kernel_inputs(kind, shapes, boxes, bidx, lvl, pcfg)

    launches = _device_launches(run)
    own = {k: v for k, v in launches.items() if _is_backward_launch(k)}
    rest = [v for k, v in launches.items() if not _is_backward_launch(k)]
    return {
        "kind": kind, "P": pcfg.output_size, "rois": len(boxes),
        "dtype": str(dout.dtype).replace("torch.", ""),
        "wrapper_ms": cs.cuda_ms(torch, run, 20),
        "wrapper_host_ms": _host_ms(run),
        "backward_launches_ms": own,
        "backward_device_ms": sum(v[0] for v in own.values()),
        "layout_device_ms": sum(v[0] for v in rest),
        "layout_launches": sum(v[1] for v in rest),
        "layout_ms": cs.cuda_ms(torch, layout, 20),
        "layout_host_ms": _host_ms(layout),
        "layout_host_ops": _host_ops(layout),
        "window_layout_ms": cs.cuda_ms(torch, lambda: poolers.window_layout(
            shapes, boxes, bidx, lvl, pcfg), 20),
        "layout_kernels": {k: v for k, v in sorted(launches.items(), key=lambda kv: -kv[1][0])
                           if not _is_backward_launch(k)},
        "tile_load": tile_load(poolers, shapes, boxes, bidx, lvl, pcfg),
    }


def main():
    if not torch.cuda.is_available():
        print("profile_roi_backward: no CUDA device", file=sys.stderr)
        return 1
    kind = sys.argv[sys.argv.index("--kind") + 1] if "--kind" in sys.argv else "roi"
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    from maskrcnn_tpu_torch.config import flagship_cfg
    from maskrcnn_tpu_torch.engine import make_train_step
    from maskrcnn_tpu_torch.models import build_detection_model, detector, poolers
    from maskrcnn_tpu_torch.ops import native
    from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer
    from maskrcnn_tpu_torch.tools.profile_train import train_batch

    if kind not in poolers.BACKWARDS:
        raise ValueError("--kind takes one of " + ", ".join(poolers.BACKWARDS))
    logs = native.build(native.KERNELS)
    if "roi_align" in logs:
        print("ptxas:", json.dumps(register_report(logs["roi_align"])), flush=True)
    sources = {}
    if kind == "roi":
        sources["profiled"] = _instrumented_source()
        if "--layouts" in sys.argv[1:]:
            sources.update({"s%d_w%d" % lw: _layout_source(*lw) for lw in LAYOUTS})
    others = [sys.argv[i + 1] for i, a in enumerate(sys.argv) if a == "--variant"]
    for d in others:
        path = os.path.join(d, "maskrcnn_tpu_torch", "csrc", "roi_align.cu")
        sources["variant_" + os.path.basename(os.path.normpath(d))] = open(path).read()
    variants = _build_variants(native, sources)
    profiled = variants.pop("profiled", None)
    layouts = {k: v for k, v in variants.items() if not k.startswith("variant_")}
    others = {k: v for k, v in variants.items() if k.startswith("variant_")}
    card = cs.card_line()
    print("card:", card, flush=True)
    cfg = flagship_cfg()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    model = build_detection_model(cfg, device="cuda", seed=cs.SEED)
    batch = train_batch(cs.TRAIN_BATCH, cs.TRAIN_HW, cs.TRAIN_SIZE, cfg.TPU.MAX_GT_BOXES,
                        cfg.TPU.GT_MASK_SIZE, cs.SEED, "cuda")
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
        phases = kernel_phases(cs, native, poolers, kind, shapes, boxes, bidx, pcfg, dout,
                               others)
        if kind != "roi":
            res = window_split(cs, poolers, kind, shapes, boxes, bidx, pcfg, dout)
            res.update(kernel=phases, card=card)
            print(json.dumps(res), flush=True)
            continue
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
            b = bx[mask].contiguous()
            d = dout[mask].contiguous()
            inputs = poolers.roi_tile_inputs(shapes, bidx[mask], lvl[mask])
            return cs.cuda_ms(torch, lambda: poolers.launch_backward(
                shapes, b, pcfg, d, out, "roi", inputs), 20)

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
            poolers.launch_backward(shapes, boxes, pcfg, dout, out, "roi",
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
        res["kernel"] = phases
        for rnd in range(2):
            for name, lib in layouts.items():
                native._LIBS["roi_align"] = lib
                try:
                    res.setdefault("layouts_ms", {}).setdefault(name, []).append(kernel_ms())
                finally:
                    native._LIBS["roi_align"] = saved
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
