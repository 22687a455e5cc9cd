"""gn_ms.train: device milliseconds a training step of the program's group
norms, forward and backward (models/layers.py:group_norm, the span
"group_norm" around each call): the kernels launched under the span and
under the backward nodes of its ops (Reading.span_s). None where the span
never opened (a program without it)."""


def read(ctx):
    r = ctx.reading
    seconds = r.span_s("group_norm")
    if seconds is None:
        return None
    return 1e3 * seconds / r.steps
