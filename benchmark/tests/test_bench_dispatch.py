"""CPU tests of what the harness finds through a configuration: its
reference module and its counts module by name, the kernel families as
files, and the device time under a span. A test-only configuration, whose
box head the benchmark's own reference cannot build, runs a whole cell
through modules and files that only the test provides.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import copy
import json
import os
import re
import shutil
import sys
import types

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

from benchmark.counts import mask_rcnn_r50  # noqa: E402
from benchmark.harness import cells, main, program, spec, trace, weights  # noqa: E402
from benchmark.harness import traffic as gen  # noqa: E402
from benchmark.reference import model as ref_model  # noqa: E402
from benchmark.reference import solver as ref_solver  # noqa: E402

import tiny  # noqa: E402

TRAIN = "mask_rcnn_R_50_FPN_1x.train_b16"
TRAIN_C4 = "mask_rcnn_R_50_C4_1x.train_b8"
INFER = "mask_rcnn_R_50_FPN_1x.infer_b8"
INFER_C4 = "mask_rcnn_R_50_C4_1x.infer_b8"
SEED = 2 ** 33 + 777
FAMILIES = {"nms", "matcher", "roi_fwd", "roi_bwd"}


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


# -- the counts by name ---------------------------------------------------------------

# Run.counts of each cell at each padded size its traffic makes, as the
# harness computed them before the counts moved into the configuration's
# module (counts/mask_rcnn_r50.py)
BEFORE = {
    (TRAIN, (800, 1344)): {"flops": 21435021975552, "pooler_bound_s": 0.0006206026889552239,
                           "nms_matcher_bound_s": 7.472453731343284e-06},
    (TRAIN_C4, (800, 1333)): {"flops": 25120027459584, "pooler_bound_s": 0.001145401160597015,
                              "nms_matcher_bound_s": 1.5371940298507463e-06},
    (INFER, (800, 1088)): {"flops": 3624410517504, "nms_bound_s": 1.1032835820895522e-06},
    (INFER, (1088, 800)): {"flops": 3624410517504, "nms_bound_s": 1.1032835820895522e-06},
    (INFER_C4, (800, 1067)): {"flops": 14433750220800, "nms_bound_s": 1.155820895522388e-06},
    (INFER_C4, (1067, 800)): {"flops": 14433750220800, "nms_bound_s": 1.155820895522388e-06},
}


def _cell_sizes(run):
    """The padded sizes of the cell's batches, from its traffic."""
    t, c = run.traffic, run.cfg
    div = c["DATALOADER"]["SIZE_DIVISIBILITY"]
    if run.kind == "train":
        return [gen.padded(*t["image_size"], div)]
    i = c["INPUT"]
    return [gen.padded(*gen.resized_size(*s, i["MIN_SIZE_TEST"], i["MAX_SIZE_TEST"]), div)
            for s in t["source_sizes"]]


@pytest.mark.parametrize("workload", [TRAIN, TRAIN_C4, INFER, INFER_C4])
def test_step_counts_as_before(workload):
    """The configuration's step_counts at the cell's shapes gives what
    Run.counts gave before the move, key for key and value for value."""
    run = cells.Run(spec.Cell(spec.benchmark(), workload), 1, "cpu")
    assert run.cell.counts is mask_rcnn_r50
    sizes = _cell_sizes(run)
    assert {(workload, hw) for hw in sizes} == {k for k in BEFORE if k[0] == workload}
    for hw in sizes:
        got = mask_rcnn_r50.step_counts(run.cfg, run.traffic["batch"], hw, run.kind == "train")
        assert got == BEFORE[(workload, hw)] and run.counts(hw) == got


# -- the reference by name ------------------------------------------------------------


@pytest.mark.parametrize("workload", [TRAIN, INFER_C4])
def test_reference_through_the_configuration(workload):
    """Both configurations resolve to reference/model.py; the weights it
    calibrates and the readings of the model built through the dispatch
    are those of ref_model.MaskRCNN and solver.calibrate_frozen_bn, bit
    for bit."""
    cell = spec.Cell(spec.benchmark(), workload)
    assert cell.reference is ref_model and cell.config["reference"] == "model"
    run = cells.Run(cell, 3, "cpu", tiny.overrides(workload))
    train = run.kind == "train"
    pool = (gen.train_pool if train else gen.infer_pool)(run.traffic, run.cfg, run.seed, "cpu")
    batch = pool[0][0] if train else pool[0]
    state = run.make_state(batch)

    direct = ref_model.MaskRCNN(run.cfg)
    direct.load_state_dict(weights.seeded_state(program.state_shapes(run.pcfg), run.init,
                                                run.seed, "cpu"))
    ref_solver.calibrate_frozen_bn(direct, batch)
    plain = direct.state_dict()
    assert set(plain) == set(state) and all(torch.equal(plain[k], state[k]) for k in state)

    through = run.reference(state)
    if train:
        cap = run.cfg["TPU"]["MASK_ROI_CAP"]
        a = through.train_forward(batch, pool[0][1], cap)
        b = direct.train_forward(batch, pool[0][1], cap)
    else:
        with torch.no_grad():
            a, b = through.infer_forward(batch), direct.infer_forward(batch)
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_missing_parts_name_the_configuration(monkeypatch):
    config = {"name": "cfg_x", "reference": "no_such_reference"}
    with pytest.raises(RuntimeError, match="cfg_x.*no_such_reference"):
        spec.part(config, "reference", spec.REFERENCE_API)
    with pytest.raises(RuntimeError, match="cfg_x.*counts"):
        spec.part(config, "counts", spec.COUNTS_API)  # no "counts" key
    partial = types.ModuleType("benchmark.reference.partial_test")
    partial.MaskRCNN = ref_model.MaskRCNN
    monkeypatch.setitem(sys.modules, partial.__name__, partial)
    with pytest.raises(RuntimeError, match="cfg_x.*set_precision, training_proposals, calibrate"):
        spec.part(dict(config, reference="partial_test"), "reference", spec.REFERENCE_API)


def test_harness_names_no_model():
    """No module of the harness names the reference model, its calibration
    or the FLOP count: each is found through the configuration."""
    pattern = re.compile(r"reference[.]model|reference import model|calibrate_frozen_bn"
                         r"|counts[.]flops|counts import flops|step_flops")
    harness = os.path.join(ROOT, "benchmark", "harness")
    for name in sorted(os.listdir(harness)):
        if name.endswith(".py"):
            with open(os.path.join(harness, name)) as f:
                assert not pattern.search(f.read()), name


# -- the kernel families as files -------------------------------------------------


def test_kernel_families_as_files():
    """kernels/<family>.json: the same four families, each counter of the
    program's, summed as the harness summed them before."""
    from maskrcnn_tpu_torch.models import poolers
    from maskrcnn_tpu_torch.ops import matcher, nms

    families = spec.kernel_families()
    assert set(families) == FAMILIES
    assert families["nms"]["kernels"] == ("nms_reduce_kernel",)
    assert families["nms"]["with"] == ("nms_mask_kernel",)
    counts = program.launch_counters(families)
    assert counts == {"nms": nms.batched_nms.launches,
                      "matcher": matcher.match_anchors_batched.launches,
                      "roi_fwd": poolers.multilevel_roi_align.launches,
                      "roi_bwd": (poolers.roi_align_backward.launches
                                  + poolers.roi_align_backward_rmw.launches
                                  + poolers.roi_align_backward_chunk.launches)}
    with pytest.raises(ValueError):
        program.counter("benchmark.harness.spec:ROOT")


def test_overlapping_kernel_families_refused(tmp_path, monkeypatch):
    """A family file whose substring contains, or lies in, one of another
    family's is a set-up error, so it cannot take that family's kernels."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark", "kernels"), bench_dir / "kernels")
    monkeypatch.setattr(spec, "BENCH_DIR", str(bench_dir))
    assert set(spec.kernel_families()) == FAMILIES
    for extra in ({"kernels": ["roi_align_fwd_kernel_v2"]}, {"kernels": ["align"]},
                  {"kernels": ["gn_kernel"], "with": ["nms_mask"]}):
        (bench_dir / "kernels" / "added.json").write_text(json.dumps(
            dict(extra, counters=["maskrcnn_tpu_torch.ops.nms:batched_nms.launches"])))
        with pytest.raises(RuntimeError, match="overlap"):
            spec.kernel_families()
    (bench_dir / "kernels" / "added.json").write_text(json.dumps(
        {"kernels": ["group_norm_fwd_kernel"], "counters": []}))
    assert set(spec.kernel_families()) == FAMILIES | {"added"}


def test_traced_run_launched_families():
    """A traced run's `launched` has one entry a family, as before."""
    run = cells.Run(spec.Cell(spec.benchmark(), TRAIN), SEED, "cpu", tiny.overrides(TRAIN))
    body = cells.TrainCell(run)
    reading = body.traced(trace.Window(run.device, program.POOLER_ENTRY, run.cell.families,
                                       program.launch_counters))
    assert set(reading.launched) == FAMILIES
    assert all(v >= 0 for v in reading.launched.values())
    # the CPU runs the plain paths: a span that opened reads 0 device seconds
    assert reading.span_s("roi_pool") == 0.0 and reading.span_s("no_such_span") is None


# -- the device time under a span ---------------------------------------------------


def _event(eid, name, children=(), kernels=(), seq=-1, thread=1, fwd_thread=None):
    e = types.SimpleNamespace(id=eid, name=name, cpu_children=list(children),
                              kernels=[types.SimpleNamespace(name=n, duration=d)
                                       for n, d in kernels],
                              sequence_nr=seq, thread=thread)
    if fwd_thread is not None:
        e.fwd_thread = fwd_thread
    return e


def _reading(cpu, names, kernels=None):
    """A Reading of hand-made host events and kernel sums."""
    r = trace.Reading.__new__(trace.Reading)
    r._cpu, r._names = cpu, names
    r.kernels = kernels or {}
    r.families = spec.kernel_families()
    return r


def test_span_s_joins_backward_and_counts_each_id_once():
    """span_s: the kernels under the span and its parts, and under the
    backward nodes of its forward ops (sequence number and forward thread),
    each correlation id once; not under a span that only shares a prefix,
    nor a backward node of another op, nor the ranges' own device spans."""
    node = trace.BACKWARD_NODE + " RoIAlignFunctionBackward"
    op = _event(2, "RoIAlignFunction", seq=10, thread=1, kernels=[("fwd_k", 3.0)],
                children=[_event(2, "cuLaunchKernel", kernels=[("fwd_k", 3.0)])])
    span = _event(1, "roi_pool", children=[op], kernels=[("roi_pool", 50.0)])
    bwd_part = _event(5, "roi_pool.bwd",
                      children=[_event(6, "aten::zeros", kernels=[("memset_k", 2.0)])])
    joined = _event(4, node, seq=10, thread=2, fwd_thread=1, kernels=[("bwd_k", 7.0)],
                    children=[bwd_part])
    other_thread = _event(7, node, seq=10, thread=2, fwd_thread=9, kernels=[("x_k", 100.0)])
    other_op = _event(8, node, seq=11, thread=2, fwd_thread=1, kernels=[("y_k", 100.0)])
    prefix = _event(9, "roi_pooling", kernels=[("z_k", 100.0)])
    cpu = [span, op, *op.cpu_children, joined, bwd_part, *bwd_part.cpu_children,
           other_thread, other_op, prefix]
    r = _reading(cpu, {"roi_pool", "roi_pool.bwd", "roi_pooling"})
    assert r.span_s("roi_pool") == pytest.approx(12.0e-6)
    assert r.span_s("roi_pool.bwd") == pytest.approx(2.0e-6)
    assert r.span_s("proposals") is None


def test_hand_reads_the_family_files():
    kernels = {"void (anonymous namespace)::nms_reduce_kernel<4>(...)": [0.002, 3],
               "void (anonymous namespace)::nms_mask_kernel(...)": [0.001, 3],
               "void (anonymous namespace)::roi_align_fwd_kernel<float>(...)": [0.004, 2],
               "sm90_xmma_gemm": [0.5, 9]}
    r = _reading([], set(), kernels)
    assert r.hand("nms") == (pytest.approx(0.003), 3)
    assert r.hand("roi_fwd") == (pytest.approx(0.004), 2) and r.hand("matcher") == (0, 0)
    r.launched = {"nms": 6, "roi_fwd": 2, "matcher": 0}
    assert r.kept_share(("nms", "roi_fwd", "matcher")) == 0.5


# -- a configuration of the test's own ----------------------------------------------

XCONV = "xconv_test"
XCONV_CELL = XCONV + ".train_b16"


class XconvBoxHead(nn.Module):
    """The program's FPNXconv1fcFeatureExtractor without group norm
    (models/roi_heads/box_head.py): NUM_STACKED_CONVS 3x3 convs with a bias
    and a ReLU, then fc6 and a ReLU over the (P, P, C)-ordered features;
    the predictor of reference/model.py's BoxHead."""

    predict = ref_model.BoxHead.predict

    def __init__(self, cfg, c):
        super().__init__()
        h = cfg["MODEL"]["ROI_BOX_HEAD"]
        fe = self.feature_extractor = nn.Module()
        fe.convs = nn.ModuleList()
        for _ in range(h["NUM_STACKED_CONVS"]):
            block = nn.Module()
            block.conv = ref_model.Conv2d(c, h["CONV_HEAD_DIM"], 3, padding=1)
            fe.convs.append(block)
            c = h["CONV_HEAD_DIM"]
        fe.fc6 = ref_model.Linear(c * h["POOLER_RESOLUTION"] ** 2, h["MLP_HEAD_DIM"])
        self.res5 = False
        self.out_dim = h["MLP_HEAD_DIM"]
        self.predictor = nn.Module()
        self.predictor.cls_score = ref_model.Linear(self.out_dim, h["NUM_CLASSES"])
        self.predictor.bbox_pred = ref_model.Linear(self.out_dim, h["NUM_CLASSES"] * 4)

    def extract(self, pooled):
        x = pooled.permute(0, 3, 1, 2)
        for block in self.feature_extractor.convs:
            x = F.relu(block.conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return F.relu(self.feature_extractor.fc6(x))


MLP = {"MODEL": {"ROI_BOX_HEAD": {"FEATURE_EXTRACTOR": "FPN2MLPFeatureExtractor"}}}


def _xconv_modules(calls):
    """The test configuration's reference and counts modules."""

    class MaskRCNN(ref_model.MaskRCNN):
        def __init__(self, cfg):
            super().__init__(cells.merged(cfg, MLP))
            self.cfg = cfg
            self.roi_heads.box = XconvBoxHead(cfg, self.backbone.out_channels)

    def calibrate(model, batch):
        calls.append("calibrate")
        ref_model.calibrate(model, batch)

    reference = types.ModuleType("benchmark.reference." + XCONV)
    reference.MaskRCNN = MaskRCNN
    reference.calibrate = calibrate
    for name in ("set_precision", "training_proposals", "box_head_inference",
                 "select_proposals", "ops"):
        setattr(reference, name, getattr(ref_model, name))

    def step_counts(cfg, batch, hw, train):
        out = mask_rcnn_r50.step_counts(cells.merged(cfg, MLP), batch, hw, train)
        h = cfg["MODEL"]["ROI_BOX_HEAD"]
        out["xconv_bound_s"] = 1e-6 * batch * h["NUM_STACKED_CONVS"] * h["CONV_HEAD_DIM"]
        return out

    counts = types.ModuleType("benchmark.counts." + XCONV)
    counts.step_counts = step_counts
    return reference, counts


PROBE = '''"""xconv_probe.train: a test's reader of the configuration and of its
counts module's own bound."""


def read(ctx):
    return ctx.cfg["MODEL"]["ROI_BOX_HEAD"]["NUM_STACKED_CONVS"] * ctx.counts["xconv_bound_s"]
'''


@pytest.fixture
def xconv_bench(tmp_path, monkeypatch):
    """(BENCHMARK.json as data, the calls of its reference's calibration)
    with the test's configuration, cell, metric and modules added, read
    from a copy of benchmark/: no file of the benchmark is edited."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(os.path.join(ROOT, "benchmark"), bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    config = spec.load_json(bench_dir / "configs" / "mask_rcnn_R_50_FPN_1x.json")
    config.update(name=XCONV, reference=XCONV, counts=XCONV)
    config["config"]["MODEL"]["ROI_BOX_HEAD"].update(
        FEATURE_EXTRACTOR="FPNXconv1fcFeatureExtractor", NUM_STACKED_CONVS=4,
        CONV_HEAD_DIM=256, USE_GN=False)
    config["init"].insert(0, ["^roi_heads[.]box[.]feature_extractor[.]convs[.].*weight$",
                              "kaiming_normal_fanin", None])
    (bench_dir / "configs" / (XCONV + ".json")).write_text(json.dumps(config))
    shutil.copy(bench_dir / "limits" / (TRAIN + ".json"),
                bench_dir / "limits" / (XCONV_CELL + ".json"))
    (bench_dir / "metrics" / "xconv_probe.train.py").write_text(PROBE)
    bench = copy.deepcopy(spec.benchmark())
    bench["workloads"].append({"name": XCONV_CELL, "config": XCONV, "traffic": "train_b16",
                               "chips": 1, "why": "a test's configuration"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if TRAIN in m.get("workloads", ()):
            m["workloads"].append(XCONV_CELL)
    bench["per_layer"].append({"name": "xconv_probe.train", "unit": "s", "better": "lower",
                               "source": "program_counter", "layer": "test",
                               "moves": "train_img_per_s", "workloads": [XCONV_CELL]})
    calls = []
    reference, counts = _xconv_modules(calls)
    monkeypatch.setitem(sys.modules, reference.__name__, reference)
    monkeypatch.setitem(sys.modules, counts.__name__, counts)
    monkeypatch.setattr(spec, "BENCH_DIR", str(bench_dir))
    return bench, calls


def _xconv_overrides():
    over = tiny.overrides(XCONV_CELL)
    over["config"] = cells.merged(over["config"], {"MODEL": {"ROI_BOX_HEAD": {
        "NUM_STACKED_CONVS": 2, "CONV_HEAD_DIM": 8}}})
    return over


@pytest.mark.parametrize("traced", [0, 1])
def test_configuration_of_its_own(xconv_bench, traced):
    """A configuration that reference/model.py cannot build runs a whole
    cell through its own reference and counts modules, with no harness
    file edited: correct, and its reader reads the configuration and the
    counts module's own bound."""
    bench, calls = xconv_bench
    cell = spec.Cell(bench, XCONV_CELL)
    assert cell.reference.__name__ == "benchmark.reference." + XCONV
    run = cells.Run(cell, SEED, "cpu", _xconv_overrides())
    with pytest.raises(NotImplementedError):
        ref_model.MaskRCNN(run.cfg)
    r = main.run_cell(cell, SEED, 0.3, traced, "cpu", 0.0, _xconv_overrides())
    assert r["correct"] is True, r["compared"]
    assert calls == ["calibrate"]
    if traced:
        bound = 1e-6 * run.traffic["batch"] * 2 * 8
        assert r["metrics"]["xconv_probe.train"]["value"] == pytest.approx(2 * bound)
        assert set(r["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(r["metrics"]) == {"setup_s", "train_img_per_s"}


def test_limits_tool_through_the_configuration(xconv_bench):
    """tools/readings.py reads the lower reading, the control and the
    planted faults of the test's configuration through its own reference:
    the program's run passes, the pooler fault planted in that reference
    fails grad_tail, the float8 control fails a number."""
    from benchmark.tools import readings

    bench, calls = xconv_bench
    run = cells.Run(spec.Cell(bench, XCONV_CELL), SEED, "cpu", _xconv_overrides())
    rows = {what: (numbers, extra) for what, numbers, extra in readings.train_seed(run, True)}
    limits = run.cell.limits["numbers"]
    assert calls == ["calibrate"]
    assert all(v <= limits[k]["limit"] for k, v in rows["program"][0].items())
    assert rows["program"][1]["counts"]["xconv_bound_s"] > 0
    assert rows["fault_pooler_backward_zeroed"][0]["grad_tail"] > limits["grad_tail"]["limit"]
    assert any(v > limits[k]["limit"] for k, v in rows["control_fp8"][0].items())


def test_reference_that_loads_jax_gives_no_result(xconv_bench, monkeypatch):
    """A configuration's reference that brings JAX into the process while
    it decides `correct` (here a stub `jax` module put in sys.modules by the
    proposal stage it judges a training step with) ends the run with no
    result."""
    bench, calls = xconv_bench
    reference = sys.modules["benchmark.reference." + XCONV]
    plain = reference.training_proposals

    def training_proposals(*args, **kwargs):
        calls.append("training_proposals")
        sys.modules["jax"] = types.ModuleType("jax")
        return plain(*args, **kwargs)

    monkeypatch.setattr(reference, "training_proposals", training_proposals)
    monkeypatch.setitem(sys.modules, "jax", None)  # taken out again after the test
    monkeypatch.delitem(sys.modules, "jax")
    cell = spec.Cell(bench, XCONV_CELL)
    with pytest.raises(SystemExit, match="jax"):
        main.run_cell(cell, SEED, 0.3, 0, "cpu", 0.0, _xconv_overrides())
    assert "training_proposals" in calls  # the window closed with no JAX held
