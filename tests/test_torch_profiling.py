"""The port's profiling surface on the CPU: the model's phase ranges, the
trainer's trace hook, the profile readers, the FLOP count and the two
profiling tools.

* The record_function ranges that the port records under a CPU
  torch.profiler equal as sets the jax.named_scope names in the lowering of
  JAX's make_train_step / infer_forward on the same tiny config (read from
  ``lower(...).as_text(debug_info=True)``, nothing compiled), and besides
  them the port's own spans (``profiling.PORT_SPANS``) that the CPU path
  reaches: a train step (train_forward, backward, the optimizer) of a tiny
  Keypoint R-CNN with the mask head on as well (the keypoint YAML with
  MASK_ON: both heads' scopes in one lowering), and infer_forward of a
  tiny Mask R-CNN; uint8 images in both, so that JAX's image_prep scope
  holds operations.
* ``do_train`` under MASKRCNN_TPU_PROFILE_DIR / _AT 2, through a short CPU
  train_net run of 8 iterations: one Chrome trace (rank 0's) holding the
  ranges of iterations 2-7 and no other, the model's ranges inside; unset,
  no profiler starts and nothing is written.
* ``profile_summary`` and ``device_busy_ms`` on hand-made FunctionEvents
  with a range's device span (flagged, and unflagged but named as a range):
  the span is left out, and a busy time above the wall time raises.
* ``step_flops`` on a conv and an fc against their analytic count, forward
  and backward; ``device_peak_tflops`` by card name.
* ``tools/profile_train.main`` (train and --infer) and
  ``tools/step_flops.main`` on the CPU at a tiny config: their tables, by
  the phase names, labelled as host times.
"""

import json
import os
import re
import types

import numpy as np
import pytest
import torch
import yaml
from torch.autograd import DeviceType
from torch.autograd.profiler_util import EventList, FunctionEvent
from torch.profiler import ProfilerActivity, profile

import jax
import jax.numpy as jnp

from maskrcnn_tpu.config import cfg as jax_defaults
from maskrcnn_tpu.engine.train_step import make_train_step as jax_make_train_step
from maskrcnn_tpu.models import build_detection_model as build_jax_model
from maskrcnn_tpu.solver import make_optimizer as jax_make_optimizer
from maskrcnn_tpu_torch.config import cfg as torch_defaults
from maskrcnn_tpu_torch.engine import make_train_step, trainer
from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN
from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer
from maskrcnn_tpu_torch.tools import profile_train, step_flops, train_net
from maskrcnn_tpu_torch.utils import flops, profiling
from test_models import tiny
from test_torch_train_net import CONFIG, OPTS, _data_tree
from torch_port_fixtures import configs, narrow, one_torch_thread, train_batch  # noqa: F401
from torch_span_paths import PORT_SPANS_REACHED

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYPOINT_YAML = os.path.join(REPO, "configs", "e2e_keypoint_rcnn_R_50_FPN_1x.yaml")
# every name the JAX package gives a jax.named_scope (the resnet stages by
# their names); a name counts as JAX's when it is a component of an op's
# location path in the lowering
JAX_SCOPES = profiling.PHASES
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _keypoint_mask_configs():
    jcfg, tcfg = jax_defaults.clone(), torch_defaults.clone()
    for c in (jcfg, tcfg):
        c.merge_from_file(KEYPOINT_YAML)
        narrow(tiny(c))
        c.MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS = (32,) * 8
        c.MODEL.WEIGHT = ""
        c.MODEL.MASK_ON = True
        c.merge_from_list([  # the mask head of configs/e2e_mask_rcnn_R_50_FPN_1x.yaml
            "MODEL.ROI_MASK_HEAD.FEATURE_EXTRACTOR", "MaskRCNNFPNFeatureExtractor",
            "MODEL.ROI_MASK_HEAD.POOLER_SCALES", "(0.25, 0.125, 0.0625, 0.03125)",
            "MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION", "14",
            "MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO", "2",
            "MODEL.ROI_MASK_HEAD.RESOLUTION", "28",
            "MODEL.ROI_MASK_HEAD.SHARE_BOX_FEATURE_EXTRACTOR", "False"])
    return jcfg, tcfg


def _batch(keypoints):
    nb = train_batch(b=1, h=64, w=96)
    if keypoints:
        rs = np.random.RandomState(1)
        gt = nb["gt_boxes"]
        x = rs.uniform(gt[..., 0:1], gt[..., 2:3], gt.shape[:2] + (17,))
        y = rs.uniform(gt[..., 1:2], gt[..., 3:4], gt.shape[:2] + (17,))
        nb["gt_keypoints"] = np.stack([x, y, np.full_like(x, 2)], -1).astype(np.float32)
        nb["gt_labels"] = (nb["gt_labels"] > 0).astype(np.int32)
    return nb


def _jax_scopes(jcfg, nb, infer):
    model = build_jax_model(jcfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(v) for k, v in nb.items()}
    if infer:
        lowered = jax.jit(model.infer_forward).lower(
            params, {k: batch[k] for k in ("images", "image_sizes")})
    else:
        tx, _ = jax_make_optimizer(jcfg, params, model.frozen_mask(params))
        step = jax_make_train_step(model, tx, donate=False)
        lowered = step.lower(params, jax.eval_shape(tx.init, params), batch,
                             jax.random.PRNGKey(1))
    text = lowered.as_text(debug_info=True)
    return {s for s in JAX_SCOPES if re.search(r"[/(]{}[/)]".format(s), text)}


def _torch_ranges(tcfg, nb, infer):
    model = GeneralizedRCNN(tcfg).eval()  # PyTorch's default init: the names need no seed
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    if infer:
        run = model.infer_forward
    else:
        optimizer = make_optimizer(tcfg, model)
        run = make_train_step(model, optimizer, make_lr_scheduler(tcfg, optimizer),
                              generator=torch.Generator().manual_seed(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(batch)
    # torch's own ranges ("Optimizer.step#SGD.step", ...) carry a '#'
    return {n for n in profiling.range_names(prof) if "#" not in n}


@pytest.mark.parametrize("infer", [False, True])
def test_phase_ranges_are_the_jax_scopes(infer):
    jcfg, tcfg = configs() if infer else _keypoint_mask_configs()
    nb = _batch(keypoints=not infer)
    want = _jax_scopes(jcfg, nb, infer)
    assert {"image_prep", "backbone", "stem", "layer4", "fpn", "rpn_head", "mask_head"} <= want
    if infer:
        assert "box_postproc" in want and "optimizer" not in want
    else:
        assert {"mask_targets", "keypoint_head", "keypoint_loss", "optimizer"} <= want
    port = PORT_SPANS_REACHED["infer" if infer else "train", "cpu"]
    assert port <= set(profiling.PORT_SPANS) and not port & set(JAX_SCOPES)
    assert _torch_ranges(tcfg, nb, infer) == want | port


def test_trainer_trace_hook_writes_iterations_at_to_at_plus_5(tmp_path, monkeypatch):
    monkeypatch.setenv("MASKRCNN_TPU_DATA_DIR", str(_data_tree(tmp_path)))
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("MASKRCNN_TPU_PROFILE_DIR", str(trace_dir))
    monkeypatch.setenv("MASKRCNN_TPU_PROFILE_AT", "2")
    train_net.main(["--config-file", CONFIG, "--skip-test"] + OPTS + [
        "SOLVER.MAX_ITER", "8", "SOLVER.CHECKPOINT_PERIOD", "100",
        "OUTPUT_DIR", str(tmp_path / "out"), "DATALOADER.NUM_WORKERS", "0"])
    assert os.listdir(trace_dir) == ["rank0.pt.trace.json"]
    with open(trace_dir / "rank0.pt.trace.json") as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {n for n in names if n.startswith("iteration ")} == {
        "iteration {}".format(i) for i in range(2, 8)}
    assert {"backbone", "rpn_loss", "mask_targets", "optimizer"} <= names


def test_trainer_starts_no_profiler_unset(tmp_path, monkeypatch):
    monkeypatch.delenv("MASKRCNN_TPU_PROFILE_DIR", raising=False)
    monkeypatch.setenv("MASKRCNN_TPU_PROFILE_AT", "1")
    monkeypatch.setattr(trainer, "profile", lambda **kw: pytest.fail("a profiler started"))
    monkeypatch.setattr(trainer, "make_train_step",
                        lambda *a, **kw: lambda batch: {"loss": torch.zeros(())})
    batches = [{"gt_labels": torch.ones(1, 2, dtype=torch.int32)}] * 7
    saver = types.SimpleNamespace(save=lambda name, **kw: None)
    optimizer = types.SimpleNamespace(param_groups=[{"lr": 0.01}])
    monkeypatch.chdir(tmp_path)
    trainer.do_train(None, optimizer, None, batches, saver, torch.device("cpu"), 100,
                     {"iteration": 0})
    assert os.listdir(tmp_path) == []


def _event(eid, name, device, start, end, annotation=False, kernels=()):
    e = FunctionEvent(id=eid, name=name, thread=0, start_us=start, end_us=end,
                      device_type=device, use_device="cuda", is_user_annotation=annotation,
                      stack=[])
    for k, us in kernels:
        e.append_kernel(k, 0, us)
    return e


def _hand_made_trace(flagged):
    """One step: a range "backbone" around a conv that launched a 3 ms
    kernel (also handed to a bookkeeping event of the conv's correlation
    id, as the profiler does), the kernel's device event, a 0.5 ms copy,
    and the range's own device span of 3.5 ms (flagged as an annotation, or
    only named as the range)."""
    events = EventList([
        _event(1, "backbone", DeviceType.CPU, 0, 4000, annotation=True),
        _event(2, "aten::conv2d", DeviceType.CPU, 100, 200, kernels=[("conv_kernel", 3000)]),
        # CUPTI's bookkeeping inside the op, handed the op's kernels too
        _event(2, "Lazy Function Loading", DeviceType.CPU, 120, 150,
               kernels=[("conv_kernel", 3000)]),
        _event(3, "conv_kernel", DeviceType.CUDA, 300, 3300),
        _event(4, "Memcpy HtoD", DeviceType.CUDA, 3300, 3800),
        _event(5, "backbone", DeviceType.CUDA, 300, 3800, annotation=flagged),
    ], use_device="cuda")
    events._build_tree()  # the parents and children, as the profiler links them
    return types.SimpleNamespace(events=lambda: events, key_averages=events.key_averages)


@pytest.mark.parametrize("flagged", [True, False])
def test_profile_readers_leave_range_spans_out(flagged, monkeypatch):
    prof = _hand_made_trace(flagged)
    got = profiling.profile_summary(prof, 1, wall_ms=5.0)
    assert got["device_busy_ms"] == pytest.approx(3.5)
    assert got["idle_share"] == pytest.approx(0.3)
    assert [k[0] for k in got["top_kernels_ms"]] == ["conv_kernel", "Memcpy HtoD"]
    with pytest.raises(RuntimeError, match="exceeds its wall time"):
        profiling.profile_summary(prof, 1, wall_ms=3.0)
    monkeypatch.setattr(profiling, "timed", lambda step, batch, steps, device: (prof, 4.0))
    assert profiling.device_busy_ms(lambda: None, iters=1) == pytest.approx(3.5)
    monkeypatch.setattr(profiling, "timed", lambda step, batch, steps, device: (prof, 3.4))
    with pytest.raises(RuntimeError, match="exceeds its wall time"):
        profiling.device_busy_ms(lambda: None, iters=1)
    breakdown = profiling.phase_breakdown(prof, 1, "cuda")
    assert breakdown["phases"] == {"backbone": pytest.approx(3.0)}
    assert breakdown["families"] == {"conv/matmul fwd": pytest.approx(3.0)}
    assert profiling.is_hand_kernel("void (anonymous namespace)::roi_align_fwd_kernel<float>()")
    assert not profiling.is_hand_kernel("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32")


def test_step_flops_counts_conv_and_fc_and_peaks_by_name():
    conv = torch.nn.Conv2d(3, 8, 3, padding=1)
    fc = torch.nn.Linear(8 * 8 * 8, 10)
    x = torch.randn(2, 3, 8, 8)

    def step():
        fc(conv(x).flatten(1)).sum().backward()

    conv_macs = 2 * 8 * 8 * 8 * 3 * 9  # N, Cout, H, W, Cin, k x k
    fc_macs = 2 * 512 * 10
    # forward, then the weight gradients and the fc's input gradient (x
    # needs none): two FLOPs a multiply-add
    assert flops.step_flops(step) == 2 * (2 * conv_macs + 3 * fc_macs)
    assert flops.device_peak_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert flops.device_peak_tflops("NVIDIA H100 PCIe") == 756.0
    assert flops.device_peak_tflops("NVIDIA A100-SXM4-80GB") == 312.0
    assert flops.device_peak_tflops("Tesla T4") is None
    assert flops.mfu_fields(989e12, 2.0, "NVIDIA H100 80GB HBM3") == {
        "tflops_per_sec": pytest.approx(494.5), "mfu": pytest.approx(0.5)}
    assert flops.mfu_fields(1e12, 1.0, "Tesla T4") == {"tflops_per_sec": 1.0}


def _tiny_yaml(path):
    with open(CONFIG) as f:
        c = yaml.safe_load(f)
    opts = dict(zip(OPTS[::2], OPTS[1::2]))
    opts.update({"MODEL.RPN.PRE_NMS_TOP_N_TEST": "64", "MODEL.RPN.POST_NMS_TOP_N_TEST": "32",
                 "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST": "32", "INPUT.MIN_SIZE_TRAIN": "(64,)",
                 "INPUT.MAX_SIZE_TRAIN": "96", "INPUT.MIN_SIZE_TEST": "64",
                 "INPUT.MAX_SIZE_TEST": "96", "MODEL.ROI_HEADS.DETECTIONS_PER_IMG": "8"})
    for key, value in opts.items():
        node = c
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    with open(path, "w") as f:
        yaml.safe_dump(c, f, default_flow_style=False, width=1000)


def test_profile_train_and_step_flops_print_their_tables(tmp_path, monkeypatch, capsys):
    _tiny_yaml(tmp_path / "tiny.yaml")
    monkeypatch.setenv("MASKRCNN_TPU_PROFILE_CONFIG", str(tmp_path / "tiny.yaml"))
    monkeypatch.setenv("MASKRCNN_TPU_PROFILE_TOP", "5")
    monkeypatch.setattr(profile_train, "TIMED", 1)  # the tables, not the times, are tested
    monkeypatch.setattr(profile_train, "TRACED", 1)
    res = profile_train.main(["1"])
    train = capsys.readouterr().out
    assert res["timed"] == "host ops (CPU trace)" and "device_busy_ms" not in res
    assert res["linked_ms"] == pytest.approx(sum(res["phases"].values()))
    for name in ("stem", "layer1", "fpn", "rpn_head", "rpn_loss", "proposals", "box_head",
                 "mask_head", "optimizer", "layer2 bwd", "box_head bwd"):
        assert re.search(r"^  {} +\d".format(name), train, re.M), name
    assert "by op family" in train and "conv/matmul bwd" in train
    assert "[CPU (host times, no device)]" in train and "device busy" not in train
    profile_train.main(["--infer"])
    infer = capsys.readouterr().out
    assert re.search(r"^  box_postproc +\d", infer, re.M) and " bwd " not in infer
    got = step_flops.main(["1"])
    out = capsys.readouterr().out
    assert got["flops_per_step"] > 0 and "mfu" not in got
    assert "bytes accessed: not counted" in out and "mfu: not measured (CPU run)" in out
