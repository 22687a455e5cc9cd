"""CPU tests of the GN configuration's parts: its counts module against what
the reference computes (the Xconv box head's FLOPs by
torch.utils.flop_counter.FlopCounterMode, the group norms' bytes by the
inputs they see), a whole run of its cell at tiny widths through the
harness, and the planted faults of tools/gn_readings.py.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import os
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

from benchmark.counts import mask_rcnn_gn as gn_counts  # noqa: E402
from benchmark.counts import roofline  # noqa: E402
from benchmark.harness import cells, main, spec, weights  # noqa: E402
from benchmark.harness import traffic as gen  # noqa: E402
from benchmark.reference import mask_rcnn_gn as ref  # noqa: E402
from benchmark.tools import gn_readings  # noqa: E402

import tiny  # noqa: E402

GN = "mask_rcnn_R_50_FPN_Xconv1fc_1x_gn.train_b16"
SEED = 2 ** 33 + 4242


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def overrides():
    """tiny.py's widths, two groups (the stem keeps 8 channels) and a
    16-wide Xconv head."""
    over = tiny.overrides(GN)
    over["config"] = cells.merged(over["config"], {"MODEL": {
        "GROUP_NORM": {"NUM_GROUPS": 2}, "ROI_BOX_HEAD": {"CONV_HEAD_DIM": 16}}})
    return over


def tiny_run(seed=SEED):
    return cells.Run(spec.Cell(spec.benchmark(), GN), seed, "cpu", overrides())


def test_the_configuration_names_its_reference_and_counts():
    cell = spec.Cell(spec.benchmark(), GN)
    assert cell.reference is ref and cell.counts is gn_counts
    assert cell.config["config"]["SOLVER"]["IMS_PER_BATCH"] == cell.traffic["batch"] == 16
    counts = gn_counts.step_counts(cell.config["config"], 16, (800, 1344), True)
    assert counts["gn_calls"] == 69 and counts["gn_calls_bwd"] == 58
    assert counts["gn_bound_s"] * roofline.HBM_BYTES_PER_S == pytest.approx(40.847e9, rel=1e-4)


@pytest.mark.parametrize("train", [True, False])
def test_xconv_head_flops_equal_the_flop_counter(train):
    """The Xconv head's FLOPs in the counts (its four 3x3 convs, fc6 and
    the predictor, forward and, in training, backward) equal
    FlopCounterMode's over the reference's box head on that many ROIs."""
    run = tiny_run()
    cfg, b, hw = run.cfg, 2, (64, 96)
    h = cfg["MODEL"]["ROI_BOX_HEAD"]
    rois = b * (cfg["MODEL"]["ROI_HEADS"]["BATCH_SIZE_PER_IMAGE"] if train
                else cfg["MODEL"]["RPN"]["FPN_POST_NMS_TOP_N_TEST"])
    c = cfg["MODEL"]["RESNETS"]["BACKBONE_OUT_CHANNELS"]
    head = ref.XconvBoxHead(cfg, c)
    p = h["POOLER_RESOLUTION"]
    pooled = torch.randn(rois, p, p, c, requires_grad=train)
    with FlopCounterMode(display=False) as counter:
        logits, reg = head.predict(head.extract(pooled))
        if train:
            (logits.sum() + reg.sum()).backward()
    # the counts' whole step less the same step without the box head's
    # convs, fc6 and predictor
    whole = gn_counts.step(cfg, b, hw, train)
    none = cells.merged(cfg, {"MODEL": {"ROI_BOX_HEAD": {"NUM_STACKED_CONVS": 0,
                                                         "MLP_HEAD_DIM": 0}}})
    rest = gn_counts.step(none, b, hw, train)
    gn_work = sum(n for n, _ in whole.norms) - sum(n for n, _ in rest.norms)
    head_flops = (whole.fwd + whole.bwd - rest.fwd - rest.bwd
                  - gn_work * (gn_counts.GN_FWD_FLOPS + (gn_counts.GN_BWD_FLOPS if train else 0)))
    assert head_flops == counter.get_total_flops()


def test_gn_bytes_equal_the_reference_group_norms():
    """gn_bound_s's bytes, call for call, are those of the inputs the
    reference's group norms see in a training step (with a backward where
    the input carries a gradient or the norm trains), and the same counts
    at inference with none."""
    run = tiny_run()
    seen = []
    plain = ref.GroupNorm.forward

    def recording(self, x):
        seen.append((x.numel(), torch.is_grad_enabled() and (x.requires_grad
                                                             or self.scale.requires_grad)))
        return plain(self, x)

    pool = gen.train_pool(run.traffic, run.cfg, run.seed, "cpu")
    batch, draws = pool[0]
    hw = tuple(batch["images"].shape[1:3])
    model = run.reference(run.make_state(batch))
    ref.GroupNorm.forward = recording
    try:
        model.train_forward(batch, draws, run.cfg["TPU"]["MASK_ROI_CAP"])
        train_seen, seen[:] = list(seen), []
        model.infer_forward({"images": batch["images"], "image_sizes": batch["image_sizes"]})
    finally:
        ref.GroupNorm.forward = plain
    b = run.traffic["batch"]
    for calls, train in ((train_seen, True), (seen, False)):
        norms = gn_counts.step(run.cfg, b, hw, train).norms
        assert sorted(calls) == sorted(norms)
        counts = gn_counts.step_counts(run.cfg, b, hw, train)
        assert counts["gn_bound_s"] == roofline.bound_s(gn_counts.gn_bytes(run.cfg, calls))


@pytest.mark.parametrize("traced", [0, 1])
def test_gn_cell_runs_correct(traced):
    """A whole run of the GN cell at tiny widths on the CPU: correct, and
    traced, its new readers: gn_ms.train reads the span's device time (0 on
    the CPU) and gn_roofline.train nothing (no device time to divide by)."""
    cell = spec.Cell(spec.benchmark(), GN)
    r = main.run_cell(cell, SEED, 0.3, traced, "cpu", 0.0, overrides())
    assert r["correct"] is True, r["compared"]
    assert r["failed"] == 0 and r["attempted"] > 0
    if traced:
        assert r["metrics"]["gn_ms.train"]["value"] == 0.0
        assert "gn_roofline.train" not in r["metrics"]
        assert set(r["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(r["metrics"]) == {"setup_s", "train_img_per_s"}


def test_planted_gn_faults_move_the_reference():
    """tools/gn_readings.py's faults change the reference they are planted
    in (the mask head's group norms passed through; the body's over 16
    groups), and leave it whole again after their block."""
    run = tiny_run()
    pool = gen.train_pool(run.traffic, run.cfg, run.seed, "cpu")
    state = run.make_state(pool[0][0])
    batch, draws = pool[0]
    cap = run.cfg["TPU"]["MASK_ROI_CAP"]
    wide = cells.merged(run.cfg, {"MODEL": {"RESNETS": {
        "STEM_OUT_CHANNELS": 16, "RES2_OUT_CHANNELS": 64, "WIDTH_PER_GROUP": 16}}})
    losses = run.reference(state).train_forward(batch, draws, cap)
    base = {k: float(v.detach()) for k, v in losses.items()}
    with gn_readings.planted(run.ref, gn_readings.mask_head_without_gn):
        masked = run.reference(state).train_forward(batch, draws, cap)
    assert float(masked["loss_mask"].detach()) != base["loss_mask"]
    assert all(float(masked[k].detach()) == v for k, v in base.items() if k != "loss_mask")
    # 16 groups need 16 channels a norm: the body at twice tiny.py's widths
    wide_state = seeded(run, wide)
    plain = run.reference(wide_state, cfg=wide).train_forward(batch, draws, cap)
    with gn_readings.planted(run.ref, gn_readings.body_gn_16_groups):
        grouped = run.reference(wide_state, cfg=wide).train_forward(batch, draws, cap)
    assert float(grouped["loss_objectness"].detach()) != float(plain["loss_objectness"].detach())
    assert run.ref.MaskRCNN is ref.MaskRCNN


def seeded(run, cfg):
    """Seeded weights of the reference at `cfg`'s widths."""
    shapes = {k: tuple(v.shape) for k, v in ref.MaskRCNN(cfg).state_dict().items()}
    return weights.seeded_state(shapes, run.init, run.seed, "cpu")
