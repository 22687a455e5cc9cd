"""idle_unspanned_ms.train, idle_unspanned_ms.infer: device idle
milliseconds a training step or an inference batch whose gap began while
no span of the program was open on the host: under the benchmark's own
ranges ("bench.step", "bench.pooler") or under no range at all.

A check of the instrumentation, not a layer: it reads how much of the idle
time the program's spans fail to name, so it falls when a span is added,
with no change in speed, and it moves no end-to-end metric (its `moves`
names the cells' metric only because every per-layer metric must). What it
keeps in the inference cells is the harness's own host work a batch
(copies, the malformed-batch check). The rest of the idle time is the
program's, read by the span that held it."""


def read(ctx):
    r = ctx.reading
    if not r.gaps:
        return None
    s = sum(v for k, v in r.gaps.items() if k.startswith("bench.") or k == "<no range>")
    return 1e3 * s / r.steps
