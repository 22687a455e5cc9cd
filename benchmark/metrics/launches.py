"""launches.train, launches.infer: kernel-launch calls the host makes a
training step (engine/train_step.py make_train_step) or an inference batch
(make_eval_step), counted in the trace's host-side runtime events."""


def read(ctx):
    r = ctx.reading
    return r.launch_calls / r.steps if r.launch_calls else None
