"""pooler_roofline.train: the least time of a training step's ROI pooling
(benchmark/counts/roofline.py:pooler_bytes at 3.35 TB/s) over its device
time (pooler_ms.train), in %. Where the trace dropped ROIAlign kernel
records, the least time is scaled by the records kept over the launches the
program counted."""


def read(ctx):
    r = ctx.reading
    if not r.pooler_s:
        return None
    kept = r.kept_share(("roi_fwd", "roi_bwd"))
    bound = ctx.counts["pooler_bound_s"] * (1.0 if kept is None else kept)
    return 100.0 * bound / (r.pooler_s / r.steps)
