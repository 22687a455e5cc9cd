"""proposals_idle_ms.train, proposals_idle_ms.infer: device idle
milliseconds a training step or an inference batch whose gap began inside
the program's proposal stage (models/rpn.py:select_proposals, the span
"proposals" and its parts "proposals.*": candidates, nms, select), the
innermost host range open when the gap began. 0 where the trace holds
gaps but none under these spans."""


def read(ctx):
    r = ctx.reading
    if not r.gaps:
        return None
    s = sum(v for k, v in r.gaps.items() if k == "proposals" or k.startswith("proposals."))
    return 1e3 * s / r.steps
