"""pooler_ms.train: device milliseconds a training step of the ROI pooling,
box and mask, forward and backward (models/poolers.py, reached through the
pooler entry the traced run wraps in "bench.pooler"): the kernels under its
calls and under the backward nodes of their ops, and every ROIAlign kernel."""


def read(ctx):
    r = ctx.reading
    if not r.pooler_s:
        return None
    return 1e3 * r.pooler_s / r.steps
