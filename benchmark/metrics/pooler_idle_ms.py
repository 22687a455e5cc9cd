"""pooler_idle_ms.train, pooler_idle_ms.infer: device idle milliseconds a
training step or an inference batch whose gap began inside the program's
ROI pooling (models/poolers.py: the span "roi_pool" around each pooling,
and "roi_pool.bwd" around its kernels' backward), the innermost host range
open when the gap began. 0 where the trace holds gaps but none under these
spans."""


def read(ctx):
    r = ctx.reading
    if not r.gaps:
        return None
    s = sum(v for k, v in r.gaps.items() if k == "roi_pool" or k.startswith("roi_pool."))
    return 1e3 * s / r.steps
