"""nms_roofline.infer: the least time of an inference batch's NMS, the
RPN's and the box post-process's (ops/nms.py -> csrc/nms.cu; bytes at 3.35
TB/s, benchmark/counts/roofline.py) over its kernels' device time, in %, the
least time scaled by the records kept over the launches the program
counted."""


def read(ctx):
    r = ctx.reading
    seconds = r.hand("nms")[0]
    kept = r.kept_share(("nms",))
    if seconds <= 0 or kept is None:
        return None
    return 100.0 * ctx.counts["nms_bound_s"] * kept / (seconds / r.steps)
