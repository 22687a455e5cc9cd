"""The port's spans (utils/profiling.py:span, PORT_SPANS) on the CPU, and
the benchmark's readers of the idle time they hold.

* ``span`` with nothing recording returns one shared no-op context manager
  and dispatches no profiler op (the op that opens a record_function range
  is watched); under a CPU torch.profiler it records a range of its name,
  also inside an autograd Function's backward, and the profiler's flag reads
  the same on another thread (the process's flag: the ROIAlign backward's
  span runs on the autograd engine's thread on the card, where the
  profiler's state follows the engine).
* A tiny flagship train step and infer step under a CPU torch.profiler
  carry every PORT_SPANS name their path reaches, each dotted span inside a
  span of the stage before its dot, the stage spans inside the JAX phases
  that hold them, and phase_breakdown attributes host ops to them; the
  adaptive pooler (C4) runs in "roi_pool" too. roi_pool.bwd belongs to the
  ROIAlign kernels' backward, which runs only on the card
  (tests/test_torch_waits_gpu.py holds it inside "backward").
* benchmark/metrics/{idle_unspanned_ms,proposals_idle_ms,pooler_idle_ms}.py,
  loaded by path, on hand-made readings: the sums of their labels' gaps a
  step in ms, 0 without their labels, None without gaps.
"""

import importlib.util
import os
import threading
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from maskrcnn_tpu_torch.config import flagship_cfg
from maskrcnn_tpu_torch.engine import make_train_step
from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN
from maskrcnn_tpu_torch.models.poolers import PoolerConfig, multilevel_roi_align
from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer
from maskrcnn_tpu_torch.utils import profiling
from torch_port_fixtures import narrow, one_torch_thread, train_batch  # noqa: F401
from torch_span_paths import GN, GN_HOLDERS, PORT_SPANS_REACHED

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_span_untraced_is_one_shared_no_op_and_dispatches_nothing(monkeypatch):
    real = torch.ops.profiler._record_function_enter_new
    calls = []

    def watched(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", watched)
    assert not torch.autograd.profiler._is_profiler_enabled
    first = profiling.span("backward")
    assert first is profiling.span("roi_pool")
    with first:
        with profiling.span("anchors.wait"):
            torch.ones(2).add_(1)
    assert calls == []
    # the watch sees a range that is dispatched
    with torch.profiler.record_function("probe"):
        pass
    assert [c[0] for c in calls] == ["probe"]


class _Doubled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return 2 * x

    @staticmethod
    def backward(ctx, g):
        with profiling.span("probe.bwd"):
            return 2 * g


def test_span_records_a_range_of_its_name_and_reads_one_flag_on_every_thread():
    seen = {}

    def other_thread():
        seen["other"] = profiling.span("x") is not profiling.span("y")

    x = torch.ones(3, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("probe"):
            y = _Doubled.apply(x).sum()
        with profiling.span("backward"):
            y.backward()
        t = threading.Thread(target=other_thread)
        t.start()
        t.join()
    assert seen["other"]
    assert {"probe", "backward", "probe.bwd"} <= profiling.range_names(prof)
    ranges = _ranges(prof)
    _inside(ranges, "probe.bwd", {"backward"})
    with profiling.span("after"):  # off again once the profiler stops
        pass
    assert profiling.span("after") is profiling.span("other")


def _tiny_model():
    c = narrow(flagship_cfg(tiny=True))
    torch.manual_seed(0)
    return c, GeneralizedRCNN(c)


def _ranges(prof):
    """[(name, start us, end us, thread)] of the trace's user ranges."""
    return [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in prof.events()
            if getattr(e, "is_user_annotation", False)]


def _inside(ranges, name, outer):
    """Every range `name` lies inside some range named in `outer`."""
    spans = [r for r in ranges if r[0] == name]
    holders = [r for r in ranges if r[0] in outer]
    assert spans, name
    for _, a, b, _ in spans:
        assert any(s <= a and b <= e for _, s, e, _ in holders), (name, outer)


# the stage before the dot, and the JAX phases that hold a stage span
HOLDERS = {"anchors": set(), "roi_pool": {"box_head", "mask_head", "keypoint_head"},
           "backward": set(), "grad_reduce": set(), "group_norm": GN_HOLDERS}


def _check_nesting(ranges, reached):
    names = {r[0] for r in ranges}
    assert reached <= names
    for name in reached:
        if "." in name:
            _inside(ranges, name, {name.split(".")[0]})
        elif HOLDERS[name]:
            _inside(ranges, name, HOLDERS[name])


def test_train_step_carries_its_port_spans_nested():
    c, model = _tiny_model()
    optimizer = make_optimizer(c, model)
    step = make_train_step(model, optimizer, make_lr_scheduler(c, optimizer),
                           generator=torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in train_batch(b=1, h=64, w=96).items()}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(batch)
    reached = PORT_SPANS_REACHED["train", "cpu"]
    ranges = _ranges(prof)
    _check_nesting(ranges, reached)
    # backward and grad_reduce come after the forward's stages, in that order
    end = {n: max(r[2] for r in ranges if r[0] == n) for n in ("mask_targets", "backward")}
    start = {n: min(r[1] for r in ranges if r[0] == n) for n in ("backward", "grad_reduce",
                                                                  "optimizer")}
    assert end["mask_targets"] <= start["backward"]
    assert end["backward"] <= start["grad_reduce"] <= start["optimizer"]
    phases = profiling.phase_breakdown(prof, 1, "cpu")["phases"]
    for name in ("anchors", "proposals.candidates", "proposals.nms", "proposals.select",
                 "rpn_loss.match", "roi_pool", "roi_pool bwd", "box_head bwd"):
        assert phases.get(name, 0) > 0, name


def test_infer_step_carries_its_port_spans_nested():
    _, model = _tiny_model()
    nb = train_batch(b=2, h=64, w=96)
    batch = {k: torch.from_numpy(nb[k]) for k in ("images", "image_sizes")}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.eval().infer_forward(batch)
    reached = PORT_SPANS_REACHED["infer", "cpu"]
    ranges = _ranges(prof)
    _check_nesting(ranges, reached)
    assert not (set(profiling.PORT_SPANS) - reached) & {r[0] for r in ranges}
    phases = profiling.phase_breakdown(prof, 1, "cpu")["phases"]
    for name in ("anchors", "proposals.nms", "box_postproc.nms", "roi_pool"):
        assert phases.get(name, 0) > 0, name


def test_gn_train_step_carries_group_norm_in_its_stages(monkeypatch):
    """A tiny GN Mask R-CNN (configs/gn_baselines/, every group norm of the
    body, FPN and both heads) train step: the flagship's spans and
    group_norm, each group_norm inside a stage span, one a call of
    layers.group_norm; phase_breakdown gives its ops and their backward to
    "group_norm" and "group_norm bwd"."""
    from maskrcnn_tpu_torch.config import cfg as defaults
    from maskrcnn_tpu_torch.models import layers

    seen = []
    plain = layers.group_norm

    def recording(*args, **kwargs):
        seen.append(1)
        return plain(*args, **kwargs)

    c = defaults.clone()
    c.merge_from_file(os.path.join(REPO, "configs", "gn_baselines",
                                   "e2e_mask_rcnn_R_50_FPN_Xconv1fc_1x_gn.yaml"))
    narrow(c)
    c.MODEL.WEIGHT = ""
    c.MODEL.GROUP_NORM.NUM_GROUPS = 2
    c.MODEL.ROI_BOX_HEAD.CONV_HEAD_DIM = 32
    torch.manual_seed(0)
    model = GeneralizedRCNN(c)
    optimizer = make_optimizer(c, model)
    step = make_train_step(model, optimizer, make_lr_scheduler(c, optimizer),
                           generator=torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in train_batch(b=1, h=64, w=96).items()}
    monkeypatch.setattr(layers, "group_norm", recording)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(batch)
    ranges = _ranges(prof)
    _check_nesting(ranges, PORT_SPANS_REACHED["train", "cpu"] | GN["cpu"])
    _inside(ranges, "group_norm", GN_HOLDERS)
    calls = sum(r[0] == "group_norm" for r in ranges)
    assert calls == len(seen) == 69
    phases = profiling.phase_breakdown(prof, 1, "cpu")["phases"]
    assert phases.get("group_norm", 0) > 0 and phases.get("group_norm bwd", 0) > 0


class _KernelLike(torch.autograd.Function):
    """Shaped as layers.GroupNormFunction: its backward opens group_norm.bwd."""

    @staticmethod
    def forward(ctx, x):
        return x * 3

    @staticmethod
    def backward(ctx, g):
        with profiling.span("group_norm.bwd"):
            return g * 3


def test_phase_breakdown_gives_a_backward_span_its_own_ops():
    """Ops inside a port span opened in a backward node (the GN kernels'
    group_norm.bwd on the card) go to that span; the other backward ops (and
    on the CPU the node's own host time) to their forward op's phase, as
    "<phase> bwd"."""
    x = torch.ones(64, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("layer1"):
            with profiling.span("group_norm"):
                y = _KernelLike.apply(x)
            z = (y * y).sum()
        with profiling.span("backward"):
            z.backward()
    phases = profiling.phase_breakdown(prof, 1, "cpu")["phases"]
    assert phases.get("group_norm", 0) > 0 and phases.get("group_norm.bwd", 0) > 0
    assert phases.get("layer1 bwd", 0) > 0
    assert torch.equal(x.grad, torch.full_like(x, 18.0))


def test_adaptive_pooler_runs_in_roi_pool():
    pcfg = PoolerConfig(14, (1.0 / 16,), 0)
    features = [torch.randn(2, 8, 10, 16, requires_grad=True)]
    boxes = torch.tensor([[0.0, 0.0, 60.0, 40.0], [10.0, 20.0, 100.0, 120.0]] * 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = multilevel_roi_align(features, boxes, torch.tensor([0, 0, 1, 1]), pcfg,
                                   rois_per_image=2)
    assert out.shape == (4, 14, 14, 16)
    assert "roi_pool" in profiling.range_names(prof)


def _reader(stem):
    path = os.path.join(REPO, "benchmark", "metrics", stem + ".py")
    spec = importlib.util.spec_from_file_location("reader_" + stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _ctx(gaps, steps=4):
    return types.SimpleNamespace(reading=types.SimpleNamespace(gaps=gaps, steps=steps))


GAPS = {"bench.step": 0.010, "bench.pooler": 0.002, "<no range>": 0.001,
        "proposals": 0.004, "proposals.nms": 0.003, "proposals.candidates": 0.001,
        "roi_pool": 0.0005, "roi_pool.bwd": 0.0025, "backward": 0.02, "layer3": 0.006,
        "rpn_loss.match": 0.0007}


@pytest.mark.parametrize("stem,want_s", [
    ("idle_unspanned_ms", 0.013),
    ("proposals_idle_ms", 0.008),
    ("pooler_idle_ms", 0.003),
])
def test_idle_readers_sum_their_labels_a_step(stem, want_s):
    read = _reader(stem)
    assert read(_ctx(GAPS)) == pytest.approx(1e3 * want_s / 4)
    assert read(_ctx(GAPS, steps=8)) == pytest.approx(1e3 * want_s / 8)
    # gaps, but none under the reader's labels: a real zero
    assert read(_ctx({"layer3": 0.006, "backward": 0.02, "proposalsx": 1.0,
                      "roi_pooler": 1.0, "bench": 1.0})) == 0
    # no gaps at all: nothing to read
    assert read(_ctx({})) is None
    assert np.isfinite(read(_ctx({"<no range>": 0.0})))
