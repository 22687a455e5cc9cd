"""Where the port's main path makes the host wait for the card, and the
spans around those waits, on the card.

Every test here is marked ``gpu`` and skips on a machine without a CUDA
device. The file imports neither JAX nor the JAX package:

    python -m pytest -m gpu --noconftest -p no:cacheprovider -s tests/test_torch_waits_gpu.py

* One training step and one inference batch of Mask R-CNN R-50-FPN (the
  flagship config) and R-50-C4 (configs/e2e_mask_rcnn_R_50_C4_1x.yaml), at
  full width, bf16 compute, SCORE_THRESH 0 (random weights score every
  class near 1/81), training 16 or 8 images of 800x1333, inference 8 uint8
  images of 800x1067, after a warm step, under
  ``torch.cuda.set_sync_debug_mode("warn")``: every synchronizing call
  torch reports has a frame of the package inside a ``with span("<stage>.wait")``
  block (read from the package's source), and the number of calls a step is
  pinned (WAITS). A wait in the backward pass is replayed on the calling
  thread at the end of ``backward()`` and would read as a site outside any
  wait span. The table of sites is printed (``-s``).
* The flagship's training step under torch.profiler: "roi_pool.bwd", opened
  on the autograd engine's thread, lies inside the main thread's
  "backward"; every PORT_SPANS name the step reaches
  (tests/torch_span_paths.py) is recorded.
* The spans' host cost: microseconds a span with nothing recording and
  with the profiler recording, and the spans a step opens (printed, with
  the card's name and power limit; the test holds only that a span costs
  less off than on).
"""

import ast
import collections
import os
import threading
import time
import traceback
import warnings

import pytest
import torch

from maskrcnn_tpu_torch.config import cfg as defaults, flagship_cfg
from maskrcnn_tpu_torch.engine import make_train_step
from maskrcnn_tpu_torch.models import build_detection_model
from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer
from maskrcnn_tpu_torch.tools.profile_train import train_batch
from maskrcnn_tpu_torch.utils import profiling
from torch_span_paths import PORT_SPANS_REACHED

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "maskrcnn_tpu_torch")
FPN, C4 = "mask_rcnn_R_50_FPN_1x", "mask_rcnn_R_50_C4_1x"
TRAIN_BATCH = {FPN: 16, C4: 8}
# synchronizing calls a training step or an inference batch, by (config, kind)
WAITS = {(FPN, "train"): 5, (FPN, "infer"): 5, (C4, "train"): 1, (C4, "infer"): 1}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card():
    return profiling.device_line("cuda")


def _config(name):
    """Full widths (ResNet-50: 64 stem channels, 64 a group; FPN 256 and a
    1024-wide box MLP, or C4's 1024-channel res4 and res5 head), bf16."""
    if name == FPN:
        c = flagship_cfg()
    else:
        c = defaults.clone()
        c.merge_from_file(os.path.join(REPO, "configs", "e2e_mask_rcnn_R_50_C4_1x.yaml"))
        c.MODEL.WEIGHT = ""
    c.MODEL.DEVICE = "cuda"
    c.TPU.COMPUTE_DTYPE = "bfloat16"
    c.MODEL.ROI_HEADS.SCORE_THRESH = 0.0
    assert (c.MODEL.RESNETS.STEM_OUT_CHANNELS, c.MODEL.RESNETS.WIDTH_PER_GROUP,
            c.MODEL.RESNETS.BACKBONE_OUT_CHANNELS) == (64, 64, 256 if name == FPN else 1024)
    c.freeze()
    return c


def wait_blocks():
    """{source file: [(first line, last line, span name)]} of every
    ``with span("<stage>.wait")`` block in the package."""
    out = collections.defaultdict(list)
    for root, _, files in os.walk(PACKAGE):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(root, fname)
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if not isinstance(node, ast.With):
                    continue
                for item in node.items:
                    call = item.context_expr
                    if (isinstance(call, ast.Call) and call.args
                            and getattr(call.func, "id", getattr(call.func, "attr", None)) == "span"
                            and isinstance(call.args[0], ast.Constant)
                            and str(call.args[0].value).endswith(".wait")):
                        out[path].append((node.lineno, node.end_lineno, call.args[0].value))
    return dict(out)


def synchronizing_calls(fn, blocks):
    """fn() under set_sync_debug_mode("warn"): [(site, wait span or None)]
    a synchronizing call, the site the innermost frame of the package
    ("path:line function"; outside the package the thread and the innermost
    frames), the wait span the innermost package frame inside such a
    block."""
    calls = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):  # not the mode's own notice
            return
        stack = traceback.extract_stack()[:-1]
        frames = [f for f in stack if f.filename.startswith(PACKAGE)]
        site = ("{}:{} {}".format(os.path.relpath(frames[-1].filename, REPO), frames[-1].lineno,
                                  frames[-1].name) if frames else
                "<outside the package: {}; thread {}, at {}:{}, {}>".format(
                    str(message)[:3000], threading.current_thread().name, filename, lineno,
                    " < ".join("{}:{} {}".format(f.filename, f.lineno, f.name)
                               for f in stack[::-1][:6])))
        held = None
        for f in reversed(frames):
            held = next((n for a, b, n in blocks.get(f.filename, ()) if a <= f.lineno <= b),
                        None)
            if held:
                break
        calls.append((site, held))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return calls


def _train(name, device):
    c = _config(name)
    model = build_detection_model(c, device=device, seed=0)
    optimizer = make_optimizer(c, model)
    step = make_train_step(model, optimizer, make_lr_scheduler(c, optimizer),
                           generator=torch.Generator(device=device).manual_seed(0))
    d = max(c.DATALOADER.SIZE_DIVISIBILITY, 1)
    hw = (-(-800 // d) * d, -(-1333 // d) * d)
    batch = train_batch(TRAIN_BATCH[name], hw, (800, 1333), c.TPU.MAX_GT_BOXES,
                        c.TPU.GT_MASK_SIZE, 0, device)
    return lambda: step(batch)


def _infer(name, device):
    c = _config(name)
    model = build_detection_model(c, device=device, seed=0).eval()
    d = max(c.DATALOADER.SIZE_DIVISIBILITY, 1)
    hw = (-(-800 // d) * d, -(-1067 // d) * d)
    images = torch.zeros((8,) + hw + (3,), dtype=torch.uint8, device=device)
    images[:, :800, :1067] = torch.randint(0, 256, (8, 800, 1067, 3), dtype=torch.uint8,
                                           device=device)
    batch = {"images": images,
             "image_sizes": torch.tensor([[800, 1067]] * 8, dtype=torch.int32, device=device)}
    return lambda: model.infer_forward(batch)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["train", "infer"])
@pytest.mark.parametrize("name", [FPN, C4])
def test_every_wait_of_the_main_path_is_in_a_wait_span(cuda, name, kind):
    run = (_train if kind == "train" else _infer)(name, cuda)
    run()  # builds the kernels, picks the convolutions
    calls = synchronizing_calls(run, wait_blocks())
    table = collections.Counter(calls)
    print("\nsynchronizing calls, {} {} [{}]:".format(name, kind, _card()))
    for (site, held), n in sorted(table.items()):
        print("  {:>3} a step  {}  in {}".format(n, site, held))
    assert [c for c in calls if c[1] is None] == [], table
    assert len(calls) == WAITS[name, kind], table


@pytest.mark.gpu
def test_roi_pool_backward_span_lies_inside_backward(cuda):
    run = _train(FPN, cuda)
    run()
    with torch.profiler.profile(activities=profiling.activities(cuda)) as prof:
        run()
        torch.cuda.synchronize()
    ranges = [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in prof.events()
              if getattr(e, "is_user_annotation", False) and e.device_type.name == "CPU"]
    names = {r[0] for r in ranges}
    assert PORT_SPANS_REACHED["train", "cuda"] <= names
    backward = [r for r in ranges if r[0] == "backward"]
    bwd = [r for r in ranges if r[0] == "roi_pool.bwd"]
    assert len(bwd) == 2  # the box and the mask pooling
    for _, a, b, thread in bwd:
        assert any(s <= a and b <= e and t != thread for _, s, e, t in backward)


@pytest.mark.gpu
def test_span_host_cost(cuda):
    n = 200_000

    def per_span_us(make):
        t0 = time.perf_counter()
        for _ in range(n):
            with make("probe"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    off = per_span_us(profiling.span)
    ranged = per_span_us(torch.profiler.record_function)  # a range opened untraced
    with torch.profiler.profile(activities=profiling.activities(cuda)):
        on = per_span_us(profiling.span)
    spans = {}
    for name in (FPN, C4):
        for kind, make in (("train", _train), ("infer", _infer)):
            run = make(name, cuda)
            run()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            spans[name, kind] = (sum(1 for e in prof.events()
                                     if getattr(e, "is_user_annotation", False)), wall)
            del run
            torch.cuda.empty_cache()
    print("\nspan host cost [{}]: {:.4f} us off, {:.3f} us recording; a record_function "
          "range opened untraced {:.3f} us".format(_card(), off, on, ranged))
    for (name, kind), (count, wall) in spans.items():
        print("  {} {}: {} spans a step; off {:.4f} ms, recording {:.3f} ms (step under a "
              "host trace {:.1f} ms)".format(name, kind, count, count * off / 1e3,
                                            count * on / 1e3, wall * 1e3))
    assert off < ranged and off < on
