"""The command: one run of one cell, one JSON line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

With --trace 0 it measures the cell's end-to-end metrics over a window of
--seconds; with --trace 1 its per-layer metrics over a traced window of the
mix's trace_steps (or trace_batches), with the device's busy and window
seconds and a breakdown. Either way it then frees the program, runs the
float32 reference over the checked steps or the sampled batches, and
prints each number compared beside its limit, on standard error and last in
the result line. It exits with a code other than 0, and prints no result,
where there is no card or fewer than the cell asks for, and where the
process holds JAX or the JAX package once the window has closed.
"""

import argparse
import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "maskrcnn_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description="one run of one benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules(modules=None):
    """Top-level names in sys.modules that are JAX's or the JAX package's,
    compared whole (maskrcnn_tpu_torch is not maskrcnn_tpu)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(n for n in names if n in FORBIDDEN)


def refuse_forbidden():
    """Exit with no result where the process holds JAX or the JAX package."""
    found = forbidden_modules()
    if found:
        raise SystemExit("the run holds {} once the window has closed".format(", ".join(found)))


def p95(values):
    """The 95th percentile (linear between the closest ranks)."""
    import numpy as np

    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def run_cell(cell, seed, seconds, trace, device, t_start, overrides=None):
    """One run in this process: the result dict (without its printing)."""
    import torch

    from . import cells, program
    from .trace import Window

    run = cells.Run(cell, seed, device, overrides)
    body = cells.TrainCell(run) if run.kind == "train" else cells.InferCell(run)
    run.sync()
    setup_s = time.perf_counter() - t_start
    on_card = run.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    metrics, dev, breakdown = {}, {}, None
    if trace:
        reading = body.traced(Window(run.device, program.POOLER_ENTRY, cell.families,
                                     program.launch_counters))
        first = body.pool[0][0] if run.kind == "train" else body.pool[0]
        ctx = Context(run, reading, tuple(first["images"].shape[1:3]))
        for m in cell.per_layer:
            value = cell.reader(m)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"busy_s": reading.busy_s, "window_s": reading.window_s}
        breakdown = reading.breakdown()
        print("hand-kernel records kept / launched: {}".format(
            {f: [reading.hand(f)[1], reading.launched[f]] for f in reading.launched}),
              file=sys.stderr)
    else:
        done, wall = body.window(seconds)
        e2e = {"setup_s": (setup_s, "s"),
               "peak_mem_gib": (torch.cuda.max_memory_allocated() / cells.GIB if on_card
                                else None, "GiB")}
        if run.kind == "train":
            e2e["train_img_per_s"] = (done / wall, "img/s")
        else:
            e2e["infer_img_per_s"] = (done / wall, "img/s")
            e2e["infer_p95_ms"] = (p95(body.latencies) * 1e3, "ms")
        for m in cell.end_to_end:
            value, unit = e2e[m["name"]]
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": unit}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    refuse_forbidden()
    attempted, failed = body.attempted, body.failed
    if getattr(body, "faults", None):
        print("malformed batches by fault: {}".format(body.faults), file=sys.stderr)
    body.free()
    numbers = body.reference_numbers()
    correct, compared = cells.check.judge(numbers, cell.limits["numbers"])
    refuse_forbidden()  # the configuration's reference decided `correct`
    result = {"correct": correct and failed == 0, "attempted": attempted, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name() if on_card else "cpu",
                         "count": 1, "memory_peak_bytes": peak, **dev}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return result


def card_line():
    """nvidia-smi's name and power limit of the card, or why not."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return "not read ({})".format(e)
    return out.stdout.strip().splitlines()[0]


class Context:
    """What a per-layer metric's reader gets: the run's kind ("train" or
    "infer"), traffic and configuration as data (`cfg`), the traced
    window's reading, the padded image size of the cell's batches (`hw`),
    and the configuration's counts of a step's work at that size
    (`counts`: "flops" and the "*_bound_s" of its counts module)."""

    def __init__(self, run, reading, hw):
        self.kind = run.kind
        self.traffic = run.traffic
        self.cfg = run.cfg
        self.hw = hw
        self.reading = reading
        self.device = run.device
        self.counts = run.counts(hw)


def main(argv=None, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    from . import spec

    # every kernel cache at a fixed path inside the checkout, before any
    # module (the configuration's reference) imports torch
    os.environ["TRITON_CACHE_DIR"] = os.path.join(spec.ROOT, "build", "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(spec.ROOT, "build", "torch_extensions")
    bench = spec.benchmark()
    cell = spec.Cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("needs {} CUDA device(s), found {}".format(
            cell.chips, torch.cuda.device_count() if torch.cuda.is_available() else 0),
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = run_cell(cell, args.seed, args.seconds, args.trace, "cuda", t_start)
    if args.trace:  # the card's power limit, beside the shares of its peak
        print("card: {}".format(card_line()), file=sys.stderr)
    for k, c in result["compared"].items():
        print("{}: {!r} (limit {!r})".format(k, c["value"], c["limit"]), file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0

