"""nms_matcher_roofline.train: the least time of a training step's NMS and
anchor matching (ops/nms.py, ops/matcher.py -> csrc/nms.cu, csrc/matcher.cu;
bytes at 3.35 TB/s, benchmark/counts/roofline.py) over their kernels'
device time, in %, the least time scaled by the records kept over the
launches the program counted."""


def read(ctx):
    r = ctx.reading
    seconds = r.hand("nms")[0] + r.hand("matcher")[0]
    kept = r.kept_share(("nms", "matcher"))
    if seconds <= 0 or kept is None:
        return None
    return 100.0 * ctx.counts["nms_matcher_bound_s"] * kept / (seconds / r.steps)
