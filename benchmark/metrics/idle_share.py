"""idle_share.train, idle_share.infer: the share of the traced training or
inference window in which no kernel, copy or memset ran on the device, in %
(1 - busy / wall, the ranges' own device spans left out)."""


def read(ctx):
    r = ctx.reading
    return 100.0 * (1.0 - r.busy_s / r.window_s) if r.busy_s > 0 else None
