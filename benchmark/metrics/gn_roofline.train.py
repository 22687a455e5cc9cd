"""gn_roofline.train: the least time of a training step's group norms (the
configuration's counts module's gn_bound_s: every call's input and output
read and written once, and each backward's x, dy and dx, at 3.35 TB/s) over
their device time (gn_ms.train), in %. None where the span never opened or
the counts hold no group norm."""


def read(ctx):
    r = ctx.reading
    seconds = r.span_s("group_norm")
    bound = ctx.counts.get("gn_bound_s")
    if not seconds or not bound:
        return None
    return 100.0 * bound / (seconds / r.steps)
