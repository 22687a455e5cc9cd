"""The port's spans, and reading torch.profiler traces of its steps.

Every range the port opens goes through ``span(name)``: while a torch
profiler records, a ``record_function`` range of that name, stamped on the
host clock that the profiler also puts the card's kernel records on;
otherwise one read of the profiler's flag and a shared no-op context
manager, so an untraced step pays no range. The model's stages are named
as the JAX package names its ``jax.named_scope``s (``PHASES``); the
optimizer's step sits in "optimizer" (engine/train_step.py), and the
trainer's trace hook puts each traced iteration in a range of its own
(engine/trainer.py). The port's own spans (``PORT_SPANS``) name what the
JAX scopes leave out: the backward, the gradient reduction, the anchors,
the parts of the proposal stage, the matcher, the box post-process's NMS,
the ROI pooling forward and its kernel backward, the group norms, and
every call of the main path that makes the host wait for the device
("<stage>.wait"), so that an idle gap of the device that begins while the
host waits is put down to that wait.

A range is a user annotation: on the card the profiler also records a
device span for it, as long as the work launched inside it. Those spans
are not device work, so every reading here leaves them out
(``FunctionEvent.is_user_annotation``, and by name for a torch that lacks
the flag) and checks that the device's busy time fits in the wall time.

Readings:

* ``profile_summary`` / ``profile_steps``: a step's wall time, device busy
  (the kernels' and copies' summed time), idle share and top kernels;
* ``device_busy_ms``: the device busy time of a call;
* ``function_shares``: what given functions take of a step, forward and
  backward (the backward joined to its forward by sequence number);
* ``phase_breakdown``: the whole step by phase range, by op family and by
  op, each kernel attributed to the innermost span around the op that
  launched it (``PORT_SPANS``, then ``PHASES``; on a CPU trace the ops' own
  host time stands in for kernels, and is labelled so).
"""

import contextlib
import re
import subprocess
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as autograd_profiler
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

# The phase ranges, innermost first (the JAX package's tools/profile_train.py
# SCOPES order, with box_postproc, the inference scope it leaves out): a
# kernel belongs to the first of these among the ranges around its op.
PHASES = ("stem", "layer1", "layer2", "layer3", "layer4", "fpn", "backbone", "rpn_head",
          "rpn_loss", "proposals", "box_targets", "box_head", "box_loss", "box_postproc",
          "mask_head", "mask_targets", "keypoint_head", "keypoint_loss", "optimizer",
          "image_prep")
# The port's own spans, innermost first: those the JAX package has no scope
# for. A dotted name is a part of the stage before its dot (the anchors
# and roi_pool are stages of their own; backward and grad_reduce are the
# train step's); roi_pool.bwd is the ROIAlign kernels' backward, which runs
# on the autograd engine's thread inside backward; group_norm is every group
# norm of the GN models (models/layers.py), inside the stage that calls it,
# and group_norm.bwd its kernels' backward, on the autograd engine's thread.
PORT_SPANS = ("group_norm.bwd", "group_norm", "anchors.wait", "proposals.candidates",
              "proposals.nms", "proposals.select", "rpn_loss.match", "box_postproc.nms",
              "roi_pool.bwd", "roi_pool", "anchors", "grad_reduce", "backward")
_OFF = contextlib.nullcontext()


def span(name):
    """A record_function range `name` while a torch profiler records; else
    a shared no-op context manager, after one read of the profiler's flag
    (a process-wide flag: it reads the same on the autograd engine's
    threads)."""
    if autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF


# The port's hand-written CUDA kernels (csrc/*.cu), by their entry names
# (a trace names them demangled, "void (anonymous namespace)::<name><...>(...)").
HAND_KERNELS = ("nms_mask_kernel", "nms_reduce_kernel", "roi_align_fwd_kernel",
                "roi_align_bwd_tile_kernel", "matcher_kernel", "group_norm_")
BACKWARD_NODE = "autograd::engine::evaluate_function:"
_CONV_OR_MATMUL = re.compile(r"^aten::(\w*conv\w*|mm|addmm|bmm|baddbmm|matmul|linear)$")


def is_hand_kernel(name):
    """Whether a device kernel's (demangled) name is one of HAND_KERNELS."""
    return any(h in name for h in HAND_KERNELS)


def activities(device):
    """The profiler's activities for a step on `device`: the host, and the
    card's kernels when it runs there."""
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def device_line(device):
    """The device a reading comes from: on the card nvidia-smi's name and
    power limit (every card reading stands beside them), on the CPU a label
    that says its times are the host's."""
    if torch.device(device).type != "cuda":
        return "CPU (host times, no device)"
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _device_us(e, kind="self_device_time_total"):
    us = getattr(e, kind, None)  # self_cuda_time_total before torch 2.4
    return getattr(e, kind.replace("device", "cuda"), 0) if us is None else us


def range_names(prof):
    """The names of the record_function ranges in a trace."""
    return {e.name for e in prof.events()
            if e.device_type == DeviceType.CPU and getattr(e, "is_user_annotation", False)}


def _is_range(e, names):
    return bool(getattr(e, "is_user_annotation", False)) or e.key in names


def device_busy(prof, steps):
    """The device's busy milliseconds a step in a trace of `steps` steps:
    its kernels', copies' and memsets' summed time, the ranges' device
    spans left out; and those events by their totals, largest first."""
    names = range_names(prof)
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and not _is_range(e, names)),
                    key=_device_us, reverse=True)
    return sum(_device_us(e) for e in events) / 1e3 / steps, events


def check_busy(busy_ms, wall_ms, what="the step"):
    """Raise if the device reads busier than the wall clock: one stream's
    work cannot take longer than the time around it."""
    if busy_ms > wall_ms:
        raise RuntimeError("{}: device busy {:.3f} ms exceeds its wall time {:.3f} ms (a "
                           "range's device span counted?)".format(what, busy_ms, wall_ms))


def timed(step, batch, steps, device):
    """torch.profiler over `steps` calls of step(batch): (the profile, the
    wall milliseconds a step under it)."""
    synchronize(device)
    with profile(activities=activities(device)) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch)
        synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    return prof, wall_ms


def profile_steps(step, batch, steps=2):
    """Where a training step's device time goes on the card:
    profile_summary of a trace of `steps` steps."""
    prof, wall_ms = timed(step, batch, steps, "cuda")
    return profile_summary(prof, steps, wall_ms)


def profile_summary(prof, steps, wall_ms):
    """A trace of `steps` steps, per step: the wall time, the device busy
    (device_busy), the idle share and the kernels with the most time, and
    the ROIAlign path's kernels, memsets and launch calls. Raises where the
    busy time exceeds the wall time; "not measured" where the profiler saw
    no device time."""
    busy_ms, events = device_busy(prof, steps)
    if busy_ms <= 0:
        return {"wall_ms": wall_ms, "device_busy_ms": "not measured"}
    check_busy(busy_ms, wall_ms)

    def in_roi_align(e):
        while e is not None:
            if "RoIAlignFunction" in e.name:
                return True
            e = e.cpu_parent
        return False

    # memsets asked for by the ROIAlign path (its forward, the window index,
    # its backward): host calls under the pooler's autograd function; its
    # kernel launches there show that the profiler links such calls to it
    roi_calls = [e.name.lower() for e in prof.events() if e.device_type == DeviceType.CPU
                 and e.name.lower().startswith(("cuda", "cu")) and in_roi_align(e.cpu_parent)]
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
        "top_kernels_ms": [[e.key[:90], _device_us(e) / 1e3 / steps, e.count / steps]
                           for e in events[:15]],
        "roi_align_kernels_per_step": {e.key[:90]: e.count / steps for e in events
                                       if "roi_align" in e.key or "cast_to_bf16" in e.key},
        "memsets_per_step": sum(e.count for e in events if "memset" in e.key.lower()) / steps,
        "roi_align_memsets_per_step": sum("memset" in n for n in roi_calls) / steps,
        "roi_align_launch_calls_per_step": sum("launchkernel" in n for n in roi_calls) / steps,
    }


def device_busy_ms(fn, iters=3):
    """The device busy milliseconds a call of fn on the card (device_busy
    over `iters` calls after one unprofiled), checked against the calls'
    wall time; "not measured" where the profiler sees no device time."""
    fn()
    prof, wall_ms = timed(lambda _: fn(), None, iters, "cuda")
    busy_ms, _ = device_busy(prof, iters)
    if busy_ms <= 0:
        return "not measured"
    check_busy(busy_ms, wall_ms, "a call")
    return busy_ms


def _below(e):
    for c in e.cpu_children:
        yield c
        yield from _below(c)


def _kernel_us(e, names):
    """The device time of the kernels launched under e, ranges' spans left
    out; each correlation id once (the profiler hands an op's kernels also
    to the CUPTI bookkeeping events, such as lazy module loading, that share
    its id)."""
    by_id = {x.id: x.kernels for x in (e, *_below(e))}
    return sum(k.duration for kernels in by_id.values() for k in kernels if k.name not in names)


def function_shares(targets, step, batch, steps=2, summary=False):
    """What each function of `targets` ({label: (owner, attribute)}, a
    module's function or a class's method) takes of a training step's
    device time on the card, read off one torch.profiler trace of `steps`
    steps: the kernels under each of its calls (a record_function range
    named by its label) and under the backward nodes that its operators
    recorded (the autograd engine's evaluate_function events, joined to them
    by sequence number and forward thread), beside the step's device busy
    in the same trace. Per step; "not measured" where the profiler sees no
    device time. With summary=True also "profile": profile_summary of the
    same trace (whose wall and busy times these are)."""

    def ranged(label, plain):
        def call(*args, **kwargs):
            with span(label):
                return plain(*args, **kwargs)
        return call

    plain = {label: getattr(owner, attr) for label, (owner, attr) in targets.items()}
    for label, (owner, attr) in targets.items():
        setattr(owner, attr, ranged(label, plain[label]))
    try:
        prof, wall_ms = timed(step, batch, steps, "cuda")
    finally:
        for label, (owner, attr) in targets.items():
            setattr(owner, attr, plain[label])
    reading = profile_summary(prof, steps, wall_ms)
    busy_ms = reading["device_busy_ms"]
    names = range_names(prof)
    res = {"wall_ms": wall_ms, "device_busy_ms": busy_ms}
    events = prof.events()
    engine = [e for e in events if e.device_type == DeviceType.CPU
              and e.name.startswith(BACKWARD_NODE)]
    for label in targets:
        ranges = [e for e in events if e.device_type == DeviceType.CPU and e.name == label]
        forward = {(c.sequence_nr, c.thread) for r in ranges for c in _below(r)
                   if c.sequence_nr >= 0}
        backward = [e for e in engine
                    if (e.sequence_nr, getattr(e, "fwd_thread", e.thread)) in forward]
        got = {"calls": len(ranges) / steps, "backward_nodes": len(backward) / steps}
        if isinstance(busy_ms, float):
            fwd_ms = sum(_kernel_us(r, names) for r in ranges) / 1e3 / steps
            bwd_ms = sum(_kernel_us(e, names) for e in backward) / 1e3 / steps
            got.update(forward_ms=fwd_ms, backward_ms=bwd_ms, ms=fwd_ms + bwd_ms,
                       share=(fwd_ms + bwd_ms) / busy_ms)
        res[label] = got
    if summary:
        res["profile"] = reading
    return res


def _family(names, kernel, backward):
    """The op family of a timed kernel (or, on a CPU trace, op): a hand
    kernel, a convolution or matrix product, a sort or top-k, or other;
    `names` are its op's name and those of the ops around it."""
    if is_hand_kernel(kernel):
        fam = "hand kernels"
    elif any(_CONV_OR_MATMUL.match(n) for n in names):
        fam = "conv/matmul"
    elif any("sort" in n or "topk" in n for n in names):
        return "sort/top-k"
    else:
        fam = "other"
    return fam + (" bwd" if backward else " fwd")


def phase_breakdown(prof, steps, device):
    """A trace of `steps` steps by phase range, by op family and by op, per
    step. On the card the timed items are the kernels, copies and memsets
    that the profiler linked to the op that launched them; on the CPU each
    op's own host time (its children's left out), and "timed" says which.
    Each item belongs to the first of PORT_SPANS, then of PHASES, among the
    ranges around its op;
    an item under a backward node to the kernels' backward span opened
    inside that node (``group_norm.bwd``, ``roi_pool.bwd``), else to its
    forward op's phase, as "<phase> bwd"; "<unattributed>" where no phase
    range is around. "linked_ms" is the items' sum (the phases and "<unattributed>" add up to it); on the
    card, device time the profiler linked to no op (device_busy less
    linked_ms) is in no table."""
    on_card = torch.device(device).type == "cuda"
    names = range_names(prof)
    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    chains = {}

    def chain(e):
        """(names of e and the ops and ranges around it, the backward node
        it runs under or None)."""
        key = id(e)
        if key not in chains:
            parent = chain(e.cpu_parent) if e.cpu_parent is not None else ((), None)
            node = e if parent[1] is None and e.name.startswith(BACKWARD_NODE) else parent[1]
            chains[key] = ((e.name,) + parent[0], node)
        return chains[key]

    def phase_of(chain_names):
        return next((p for p in PORT_SPANS + PHASES if p in chain_names), None)

    owned = {}

    def own_span(node):
        """The kernels' backward span (a ".bwd" port span: group_norm.bwd,
        roi_pool.bwd, which hold all of their backward's launches) opened
        inside a backward node, or None. On the card the profiler links
        those launches to the node's op, around the span, not to the span."""
        if id(node) not in owned:
            inside = {c.name for c in _below(node)}
            owned[id(node)] = next((p for p in PORT_SPANS
                                    if p.endswith(".bwd") and p in inside), None)
        return owned[id(node)]

    forward = {}
    for e in events:
        if e.sequence_nr >= 0:
            names_up, node = chain(e)
            if node is None:
                forward.setdefault((e.sequence_nr, e.thread), phase_of(names_up))

    # the profiler hands an op's kernels also to the CUPTI bookkeeping events
    # (lazy module loading, ...) that share its correlation id: each id's
    # kernels are timed once, at its innermost event (an op's bookkeeping
    # runs inside the op, so it has the op's ranges around it)
    launcher = {}
    for e in events:
        if e.kernels and (e.id not in launcher or len(chain(e)[0]) > len(chain(launcher[e.id])[0])):
            launcher[e.id] = e
    items = []  # (name, microseconds, the op, its phase label, family)
    for e in events:
        if on_card:
            if launcher.get(e.id) is not e:
                continue
            timed_here = [(k.name, k.duration) for k in e.kernels if k.name not in names]
        elif not _is_range(e, names):
            timed_here = [(e.name, e.self_cpu_time_total)]
        else:
            continue
        if not timed_here:
            continue
        names_up, node = chain(e)
        if node is not None:
            phase = forward.get((node.sequence_nr, getattr(node, "fwd_thread", node.thread)))
            label = own_span(node) or (phase + " bwd" if phase else "<unattributed>")
        else:
            label = phase_of(names_up) or "<unattributed>"
        for name, us in timed_here:
            items.append((name, us, e.name, label, _family(names_up, name, node is not None)))

    per_step = lambda us: us / 1e3 / steps  # noqa: E731
    by_phase, by_family, by_op, origin = defaultdict(float), defaultdict(float), \
        defaultdict(float), {}
    for name, us, op, label, fam in items:
        by_phase[label] += per_step(us)
        by_family[fam] += per_step(us)
        by_op[name] += per_step(us)
        origin.setdefault(name, "{} / {}".format(label, op))
    ordered = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))  # noqa: E731
    return {"timed": "device kernels" if on_card else "host ops (CPU trace)",
            "linked_ms": sum(by_phase.values()), "phases": ordered(by_phase),
            "families": ordered(by_family), "ops": ordered(by_op), "origin": origin}
