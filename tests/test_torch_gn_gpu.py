"""The group norm kernels (csrc/group_norm.cu) on the card: against
group_norm_plain at the GN training cell's shapes, and a training step of
the cell's configuration through them.

Every test here is marked ``gpu`` and skips on a machine without a CUDA
device. The file imports neither JAX nor the JAX package:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gn_gpu.py

Tolerances (tools/profile_group_norm.py): the forward within 1e-5 in
float32 (the same rounded steps; the statistics summed in another order)
and one bf16 ulp of max|y| in bfloat16 (both round one float32 value);
dx, dscale and dbias within 1e-5 (float32) or 1e-2 (bfloat16: dx rounded
once) of max|grad| against autograd of the plain version in float32 on the
same values. Every sum runs in a fixed order: two calls give the same bits.
"""

import os

import pytest
import torch
from torch.autograd import DeviceType

from maskrcnn_tpu_torch.models import layers
from maskrcnn_tpu_torch.tools import profile_group_norm as pgn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GN_YAML = os.path.join(REPO, "configs", "gn_baselines",
                       "e2e_mask_rcnn_R_50_FPN_Xconv1fc_1x_gn.yaml")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("name", sorted(pgn.SHAPES))
def test_group_norm_kernel_matches_plain(cuda, name, dtype):
    got = pgn.check(pgn.SHAPES[name], pgn.DTYPES[dtype])
    assert got["forward_err"] <= got["forward_tol"], got
    assert max(got["grad_err"].values()) <= got["grad_tol"], got
    assert got["repeat_equal"] and got["y_channels_last"], got
    assert got["launches"] == [2, 2], got
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_group_norm_on_the_card_launches_or_raises(cuda):
    x = torch.randn(2, 64, 8, 8, device=cuda)
    scale, bias = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="channels_last"):
        layers.group_norm(x, scale, bias, 32)  # NCHW-contiguous: no hidden copy
    xl = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        layers.group_norm(xl.half(), scale, bias, 32)
    with pytest.raises(ValueError, match="scale and bias"):
        layers.group_norm(xl, scale.bfloat16(), bias, 32)
    with pytest.raises(ValueError, match="C % 8"):
        layers.group_norm(torch.randn(2, 12, 8, 8, device=cuda)
                          .contiguous(memory_format=torch.channels_last),
                          torch.ones(12, device=cuda), torch.zeros(12, device=cuda), 3)
    before = layers.group_norm.launches
    empty = torch.empty(0, 64, 8, 8, device=cuda).contiguous(memory_format=torch.channels_last)
    assert layers.group_norm(empty, scale, bias, 32).shape == empty.shape
    assert layers.group_norm.launches == before


@pytest.mark.gpu
def test_gn_training_step_runs_every_group_norm_on_the_kernels(cuda, monkeypatch):
    """A training step of the GN cell's configuration (its YAML, bf16, two
    images of 800x1344): 69 group norms launch the forward, the 58 outside
    the frozen stem and res2 the backward; every call's input arrives
    channels_last (the wrapper raises on any other). A second step traced:
    group_norm and group_norm.bwd (inside backward) open once a call, and
    phase_breakdown gives the group norm kernels to one or the other."""
    from maskrcnn_tpu_torch.tools import profile_train
    from maskrcnn_tpu_torch.utils import profiling
    from torch_span_paths import GN

    monkeypatch.setenv("MASKRCNN_TPU_PROFILE_CONFIG", GN_YAML)
    step, _, batch = profile_train.build_step(2, cuda)
    before = (layers.group_norm.launches, layers.group_norm.bwd_launches)
    losses = step(batch)
    torch.cuda.synchronize()
    assert all(torch.isfinite(v).all() for v in losses.values())
    assert (layers.group_norm.launches - before[0],
            layers.group_norm.bwd_launches - before[1]) == (69, 58)
    prof, _ = profiling.timed(step, batch, 1, cuda)
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == DeviceType.CPU and getattr(e, "is_user_annotation", False)]
    names = [r[0] for r in ranges]
    assert GN["cuda"] <= set(names)
    assert (names.count("group_norm"), names.count("group_norm.bwd")) == (69, 58)
    backward = [r for r in ranges if r[0] == "backward"]
    assert all(any(s <= a and b <= e for _, s, e in backward)
               for name, a, b in ranges if name == "group_norm.bwd")
    reading = profiling.phase_breakdown(prof, 1, cuda)
    phases = reading["phases"]
    assert phases.get("group_norm", 0) > 0 and phases.get("group_norm.bwd", 0) > 0
    kernels_ms = sum(ms for k, ms in reading["ops"].items() if "group_norm_" in k)
    assert all(profiling.is_hand_kernel(k) for k in reading["ops"] if "group_norm_" in k)
    # the two spans hold the kernels and nothing else; the profiler links
    # a few launches to another op (test_torch_kernels_gpu's 2%)
    spans_ms = phases["group_norm"] + phases["group_norm.bwd"]
    assert 0.98 * kernels_ms <= spans_ms <= kernels_ms * 1.0001, (spans_ms, kernels_ms)
