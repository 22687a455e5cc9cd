"""mfu.train, mfu.infer: a training step's model FLOPs (forward and
backward) or an inference batch's (forward), as benchmark/counts/flops.py
counts them, over the traced window's seconds, as a share of one H100's
dense bf16 peak (989 TFLOP/s). The traced window's seconds include the
profiler's own cost, so this reads a little under the same share taken over
an untraced window (PERF.md gives both for each cell)."""

from benchmark.counts.roofline import PEAK_BF16_FLOPS


def read(ctx):
    r = ctx.reading
    if r.busy_s <= 0:
        return None
    return 100.0 * ctx.counts["flops"] * r.steps / r.window_s / PEAK_BF16_FLOPS
