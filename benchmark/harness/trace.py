"""The traced window and its reading.

A frozen copy of the arithmetic of maskrcnn_tpu_torch/utils/profiling.py
(device_busy, check_busy, function_shares: the ranges' own device spans
left out, a backward node joined to the forward ops of a range by sequence
number and forward thread, each correlation id's kernels counted once),
read from torch.profiler over a traced window of whole steps. The program's
own record_function ranges (its phases) are its spans; the benchmark adds
three of its own: "bench.window" around the traced steps, "bench.step"
around each, and "bench.pooler" around each call of the program's pooler
entry (program.POOLER_ENTRY), in traced runs only. Reading.span_s reads
the device time under any of the program's spans; the hand-kernel families
whose records and launches it counts are the files kernels/<family>.json
(spec.kernel_families).
"""

import importlib
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

BACKWARD_NODE = "autograd::engine::evaluate_function:"
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel", "cudaGraphLaunch")
POOLER = "bench.pooler"


def _device_us(e):
    us = getattr(e, "self_device_time_total", None)
    return getattr(e, "self_cuda_time_total", 0) if us is None else us


def _is_range(e, names):
    return bool(getattr(e, "is_user_annotation", False)) or e.key in names


def _below(e):
    for c in e.cpu_children:
        yield c
        yield from _below(c)


class Window:
    """Runs `n` steps of run(i) under torch.profiler, each in a
    "bench.step" range, with the program's pooler entry wrapped in a
    "bench.pooler" range; keeps the profile, the window's wall seconds
    (synchronised at both ends) and the increments of the launch counters
    of the hand-kernel `families` (counters(families): {family: launches
    so far})."""

    def __init__(self, device, pooler_entry, families, counters):
        self.device = torch.device(device)
        self.pooler_entry = pooler_entry
        self.families = families
        self.counters = counters

    def run(self, run, n):
        module = importlib.import_module(self.pooler_entry[0])
        plain = getattr(module, self.pooler_entry[1])

        def ranged(*args, **kwargs):
            with record_function(POOLER):
                return plain(*args, **kwargs)

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        before = self.counters(self.families)
        setattr(module, self.pooler_entry[1], ranged)
        try:
            with profile(activities=acts) as prof:
                with record_function("bench.window"):
                    _sync(self.device)
                    t0 = time.perf_counter()
                    for i in range(n):
                        with record_function("bench.step"):
                            run(i)
                    _sync(self.device)
                    wall = time.perf_counter() - t0
        finally:
            setattr(module, self.pooler_entry[1], plain)
        after = self.counters(self.families)
        return Reading(prof, n, wall, {k: after[k] - before[k] for k in after}, self.families)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


class Reading:
    """What the metric readers read off one traced window: steps,
    window_s, busy_s (the union of the device's kernel, copy and memset
    spans), launch_calls (the host's kernel-launch calls), kernels {name:
    [seconds, records]}, launched {family: launches by the program's
    counters}, pooler_s (the device seconds of the pooler's forward and
    backward), gaps {host range open: idle seconds}; span_s(name), the
    device seconds under a span of the program."""

    def __init__(self, prof, steps, window_s, launched, families):
        self.steps = steps
        self.window_s = window_s
        self.launched = launched
        self.families = families
        events = prof.events()
        self._names = names = {e.name for e in events if e.device_type == DeviceType.CPU
                               and getattr(e, "is_user_annotation", False)}
        self.kernels = defaultdict(lambda: [0.0, 0])
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and not _is_range(e, names):
                self.kernels[e.key][0] += _device_us(e) / 1e6
                self.kernels[e.key][1] += e.count
        spans = sorted((e.time_range.start, e.time_range.end) for e in events
                       if e.device_type == DeviceType.CUDA and not _is_range(e, names))
        self.busy_s = sum(b - a for a, b in _union(spans)) / 1e6
        if self.busy_s > self.window_s:
            raise RuntimeError("device busy {:.6f} s exceeds the traced window {:.6f} s".format(
                self.busy_s, self.window_s))
        self._cpu = cpu = [e for e in events if e.device_type == DeviceType.CPU]
        self.launch_calls = sum(1 for e in cpu if e.name in LAUNCH_CALLS)
        self.pooler_s = self._pooler()
        self.gaps = self._gaps(cpu, names, spans)

    def family_of(self, kernel):
        """The hand-kernel family whose "kernels" or "with" names a part of
        `kernel`'s name, or None."""
        for fam, f in self.families.items():
            if any(n in kernel for n in f["kernels"] + f["with"]):
                return fam
        return None

    def hand(self, family):
        """(device seconds, records) of a hand-kernel family: the time of
        its kernels and of those launched with them, the records of its
        kernels alone (one a launch)."""
        s = n = 0
        for name, (sec, count) in self.kernels.items():
            if self.family_of(name) == family:
                s += sec
                n += count if any(k in name for k in self.families[family]["kernels"]) else 0
        return s, n

    def kept_share(self, families):
        """The least share of launches whose records the trace kept, over
        the families that launched; None where none launched."""
        shares = []
        for fam in families:
            if self.launched.get(fam, 0) > 0:
                shares.append(min(1.0, self.hand(fam)[1] / self.launched[fam]))
        return min(shares) if shares else None

    def span_s(self, name):
        """The device seconds of the kernels launched while the program's
        span `name`, or a part of it `name.*`, was open, and by the
        backward nodes of the forward ops under it; None where the span
        never opened."""
        ranges = [e for e in self._cpu if e.name == name or e.name.startswith(name + ".")]
        if not ranges:
            return None
        return sum(k.duration for ks in self._under(ranges).values() for k in ks
                   if k.name not in self._names) / 1e6

    def _under(self, ranges):
        """{event id: its kernels} of the events under `ranges` and under
        the autograd backward nodes of the forward ops under them (joined
        by sequence number and forward thread): each correlation id's
        kernels once."""
        forward = {(c.sequence_nr, c.thread) for r in ranges for c in _below(r)
                   if c.sequence_nr >= 0}
        nodes = [e for e in self._cpu if e.name.startswith(BACKWARD_NODE)
                 and (e.sequence_nr, getattr(e, "fwd_thread", e.thread)) in forward]
        by_id = {}
        for top in ranges + nodes:
            for x in (top, *_below(top)):
                by_id[x.id] = x.kernels
        return by_id

    def _pooler(self):
        ranges = [e for e in self._cpu if e.name == POOLER]
        if not ranges:
            return None
        linked = sum(k.duration for ks in self._under(ranges).values() for k in ks
                     if k.name not in self._names
                     and self.family_of(k.name) not in ("roi_fwd", "roi_bwd"))
        # the ROIAlign kernels are the pooler's wherever the profiler linked them
        return linked / 1e6 + self.hand("roi_fwd")[0] + self.hand("roi_bwd")[0]

    def _gaps(self, cpu, names, spans):
        window = [e for e in cpu if e.name == "bench.window"]
        if not window or not spans:
            return {}
        w0, w1 = window[0].time_range.start, window[0].time_range.end
        ranges = sorted(((e.time_range.start, e.time_range.end, e.name) for e in cpu
                         if e.name in names and e.name != "bench.window"),
                        key=lambda r: r[1] - r[0])
        gaps = defaultdict(float)
        edge = w0
        for a, b in _union(spans) + [(w1, w1)]:
            if a > edge:
                label = next((n for s, e, n in ranges if s <= edge < e), "<no range>")
                gaps[label] += (min(a, w1) - edge) / 1e6
            edge = max(edge, b)
        return dict(gaps)

    def breakdown(self, top=10):
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:160], v[0]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _union(spans):
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]
