"""CPU tests of the benchmark: the contract of BENCHMARK.json, the parts
found by name, the window arithmetic, the result line, the JAX check, the
reference against the program, the FLOP count, the control and the faults
that the check has to catch. At tiny widths (tiny.py); the program runs in
float32 here, so that its sound runs read far inside the cells' limits.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

from benchmark.counts import flops as flop_count  # noqa: E402
from benchmark.harness import cells, check, main, program, spec  # noqa: E402
from benchmark.harness import traffic as gen  # noqa: E402
from benchmark.reference import model as ref_model  # noqa: E402
from benchmark.reference import ops as ref_ops  # noqa: E402

import tiny  # noqa: E402

TRAIN = "mask_rcnn_R_50_FPN_1x.train_b16"
TRAIN_C4 = "mask_rcnn_R_50_C4_1x.train_b8"
INFER = "mask_rcnn_R_50_FPN_1x.infer_b8"
INFER_C4 = "mask_rcnn_R_50_C4_1x.infer_b8"
SEED = 2 ** 33 + 12345  # more than 32 bits, as the driver's are
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(autouse=True)
def few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def run(workload, trace=0, dtype="float32", seed=SEED, seconds=0.3):
    cell = spec.Cell(spec.benchmark(), workload)
    return main.run_cell(cell, seed, seconds, trace, "cpu", 0.0,
                         tiny.overrides(workload, dtype))


# -- the contract -------------------------------------------------------------


def test_benchmark_json_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and bench["command"][1].startswith("benchmark/")
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["why"]) <= 200
        data = spec.load_json(os.path.join(ROOT, c["file"]))
        assert sorted(data["reduced"]) == sorted(c["reduced"]) and data["source"] == c["source"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for w in m["workloads"]:  # each cell that reads it reports what it moves
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]


@pytest.mark.parametrize("workload", [TRAIN, TRAIN_C4, INFER, INFER_C4])
def test_parts_found_by_name(bench, workload):
    cell = spec.Cell(bench, workload)
    assert cell.traffic["kind"] in ("train", "infer") and cell.config["name"] == \
        cell.workload["config"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert cell.per_layer and all(callable(cell.reader(m)) for m in cell.per_layer)
    for k, v in cell.limits["numbers"].items():
        assert v["limit"] is not None and "readings" in v, k


def test_forbidden_modules_compare_whole_names():
    assert main.forbidden_modules(["maskrcnn_tpu_torch.models", "numpy", "torch"]) == []
    assert main.forbidden_modules(["maskrcnn_tpu.ops", "jax._src", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "maskrcnn_tpu"]


def test_run_loads_no_jax():
    """A whole run in a fresh process: no jax, jaxlib, flax or the JAX
    package among sys.modules afterwards (names compared whole)."""
    code = ("import sys, json; sys.path[:0] = [{!r}, {!r}]; import tiny; "
            "from benchmark.harness import main, spec; "
            "cell = spec.Cell(spec.benchmark(), {!r}); "
            "r = main.run_cell(cell, 7, 0.1, 0, 'cpu', 0.0, tiny.overrides({!r})); "
            "print(json.dumps(main.forbidden_modules()))").format(ROOT, HERE, INFER, INFER)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, {!r}); "
            "import benchmark.reference.model, benchmark.reference.solver, "
            "benchmark.reference.ops; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}} & "
            "{{'maskrcnn_tpu_torch', 'maskrcnn_tpu', 'jax', 'jaxlib', 'flax'}}))").format(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result():
    """Without a card the command exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
                          "--workload", INFER, "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and not out.stdout.strip()


# -- the window's arithmetic and the result line -------------------------------


def test_p95_over_every_batch():
    assert main.p95(list(range(1, 101))) == pytest.approx(95.05)
    assert main.p95([5.0] * 19 + [100.0]) == pytest.approx(9.75)


class _Steps(cells.TrainCell):
    """A TrainCell whose step takes a fixed time."""

    def __init__(self, run, step_s):
        self.run = run
        self.step_s = step_s
        self.next = 0

    def one(self, _=None):
        import time
        time.sleep(self.step_s)
        self.next += 1
        return torch.tensor(float("nan") if self.next == 2 else 1.0)


def test_training_window_counts_all_steps_and_time():
    run = cells.Run(spec.Cell(spec.benchmark(), TRAIN), 1, "cpu", tiny.overrides(TRAIN))
    body = _Steps(run, 0.05)
    images, wall = body.window(0.3)
    assert body.attempted >= 6 and images == body.attempted * run.traffic["batch"]
    assert wall >= 0.3 and wall >= body.attempted * 0.05
    assert body.failed == 1  # the non-finite loss


@pytest.mark.parametrize("workload", [TRAIN, INFER])
def test_result_line(workload):
    r = run(workload)
    assert list(r)[-1] == "compared" and set(r) >= {"correct", "attempted", "failed",
                                                    "metrics", "device"}
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    names = {"setup_s"} | ({"train_img_per_s"} if "train" in workload
                           else {"infer_img_per_s", "infer_p95_ms"})
    assert set(r["metrics"]) == names  # peak_mem_gib is a card reading
    for m in r["metrics"].values():
        assert m["value"] > 0 and set(m) == {"value", "unit"}
    for k, c in r["compared"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"], k
    json.dumps(r)


def test_traced_result_line():
    r = run(TRAIN, trace=1)
    assert set(r["device"]) >= {"busy_s", "window_s"} and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["correct"] is True


def test_same_seed_same_inputs():
    cell = spec.Cell(spec.benchmark(), TRAIN)
    runs = [cells.Run(cell, SEED, "cpu", tiny.overrides(TRAIN)) for _ in range(2)]
    pools = [gen.train_pool(r.traffic, r.cfg, r.seed, r.device) for r in runs]
    for (b1, d1), (b2, d2) in zip(*pools):
        for k in b1:
            assert torch.equal(b1[k], b2[k])
        for k in d1:
            assert torch.equal(d1[k], d2[k])
    other = gen.train_pool(runs[0].traffic, runs[0].cfg, SEED + 1, "cpu")
    assert not torch.equal(other[0][0]["images"], pools[0][0][0]["images"])


# -- the reference against the program ------------------------------------------


@pytest.mark.parametrize("workload", [TRAIN, TRAIN_C4])
def test_reference_training_matches_program(workload):
    r = cells.Run(spec.Cell(spec.benchmark(), workload), 3, "cpu", tiny.overrides(workload))
    pool = gen.train_pool(r.traffic, r.cfg, r.seed, r.device)
    state = r.make_state(pool[0][0])
    prog = program.build_model(r.pcfg, state, "cpu")
    ref = r.reference(state)
    batch, draws = pool[0]
    lp = prog.train_forward(batch, draws=draws)
    lr = ref.train_forward(batch, draws, r.cfg["TPU"]["MASK_ROI_CAP"])
    assert set(lp) == set(lr)
    for k in lp:
        assert float(lp[k].detach()) == pytest.approx(float(lr[k].detach()), rel=1e-5,
                                                      abs=1e-7), k
    sum(lp.values()).backward()
    sum(lr.values()).backward()
    gp = dict(prog.named_parameters())
    for k, p in ref.named_parameters():
        if p.requires_grad:
            a, b = gp[k].grad, p.grad
            # the mask head's gradients cancel over random targets: float32
            # sums differ by ~1% of their small norm (a float64 copy sides with
            # neither), and the body's carry some of it (C4: ~2e-3)
            tol = 3e-2 if ".mask." in k else 1e-2
            assert float((a - b).norm()) <= tol * float(b.norm()) + 1e-9, k


@pytest.mark.parametrize("workload", [INFER, INFER_C4])
def test_reference_follows_program_inference(workload):
    """Stage by stage at float32: the reference's counterparts of the
    program's RPN head, proposals, box head, detections and masks agree."""
    r = cells.Run(spec.Cell(spec.benchmark(), workload), 3, "cpu", tiny.overrides(workload))
    pool = gen.infer_pool(r.traffic, r.cfg, r.seed, r.device)
    state = r.make_state(pool[0])
    step = program.eval_step(program.build_model(r.pcfg, state, "cpu"))
    with program.capture() as cap:
        det = cells.host_detections(step(pool[0]))
    side = dict(cap.stages(1)[0], detections=det)
    assert det["valid"].any()
    numbers = check.infer_numbers(*cells.judge_detections(r, state, [(pool[0], side)]))
    assert numbers == {"rpn_tail": 0.0, "proposal_miss": 0.0, "box_head_tail": 0.0,
                       "detection_miss": 0.0, "mask_tail": 0.0}


@pytest.mark.parametrize("workload", [TRAIN, TRAIN_C4])
def test_reference_follows_program_training(workload):
    """At float32 the reference, taking the program's proposals, repeats
    its first gradients and its proposal stage."""
    r = cells.Run(spec.Cell(spec.benchmark(), workload), 3, "cpu", tiny.overrides(workload))
    body = cells.TrainCell(r)
    body.free()
    numbers, ref = cells.judge_training(r, body.state, body.pool, body.readings)
    assert numbers["proposal_miss"] == 0 and numbers["rpn_grad_tail"] == 0
    for a, b in zip(body.readings["losses"], ref["losses"]):
        assert a == pytest.approx(b, rel=1e-5)
    # float32 sums of cancelling terms in another order: the body's
    # gradients agree to a few percent of their norm, not element by element
    assert numbers["grad_tail"] < 1e-3 and numbers["change_gap"] < 0.1


# -- the FLOP count --------------------------------------------------------------


@pytest.mark.parametrize("workload", [TRAIN, TRAIN_C4, INFER, INFER_C4])
def test_flop_count_matches_flop_counter(workload, monkeypatch):
    """The analytic count against FlopCounterMode over the reference's
    step at tiny widths, its matmul pooler replaced by the gather path
    (ROI pooling is not counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    plain = ref_ops.roi_align_adaptive
    monkeypatch.setattr(ref_ops, "roi_align_adaptive",
                        lambda f, b, i, p, rois_per_image=None: plain(f, b, i, p, None))
    r = cells.Run(spec.Cell(spec.benchmark(), workload), 5, "cpu", tiny.overrides(workload))
    train = r.kind == "train"
    pool = (gen.train_pool if train else gen.infer_pool)(r.traffic, r.cfg, r.seed, r.device)
    batch = pool[0][0] if train else pool[0]
    model = r.reference(r.make_state(batch))
    with FlopCounterMode(display=False) as counter:
        if train:
            losses = model.train_forward(batch, pool[0][1], r.cfg["TPU"]["MASK_ROI_CAP"])
            sum(losses.values()).backward()
        else:
            model.infer_forward(batch)
    fwd, bwd = flop_count.step_flops(r.cfg, r.traffic["batch"], tuple(batch["images"].shape[1:3]),
                                     train)
    assert fwd + bwd == counter.get_total_flops()


def test_flop_count_full_size():
    """The cells' counts at their own sizes (what mfu.train and mfu.infer
    divide): the body and heads of a batch-16 FPN step ~21.5 TFLOP, as
    FlopCounterMode read ~10.75 a batch-8 step on the card."""
    cfg = spec.load_json(os.path.join(ROOT, "benchmark", "configs",
                                      "mask_rcnn_R_50_FPN_1x.json"))["config"]
    fwd, bwd = flop_count.step_flops(cfg, 16, (800, 1344), True)
    assert 18e12 < fwd + bwd < 25e12


# -- the control and the faults --------------------------------------------------


def _reference_in_place(monkeypatch, precision):
    """The reference, at `precision`, in the program's place."""
    from benchmark.reference import solver as ref_solver

    def build(pcfg, state, device):
        model = ref_model.MaskRCNN(json.loads(json.dumps(pcfg))).to(device)
        model.load_state_dict(state)
        ref_model.set_precision(model, precision)
        return model

    def step(pcfg, model):
        opt, sched = ref_solver.make_sgd(pcfg["SOLVER"], model)
        cap = pcfg["TPU"]["MASK_ROI_CAP"]

        def one(batch, draws):
            losses = model.train_forward(batch, draws, cap)
            total = sum(losses.values())
            opt.zero_grad(set_to_none=True)
            total.backward()
            opt.step()
            sched.step()
            return {"loss": total.detach()}
        return one, opt

    class capture(program.capture):
        MODULE = "benchmark.reference.model"

    monkeypatch.setattr(program, "build_model", build)
    monkeypatch.setattr(program, "train_step", step)
    monkeypatch.setattr(program, "eval_step", lambda model: model.infer_forward)
    monkeypatch.setattr(program, "capture", capture)


@pytest.mark.parametrize("workload", [TRAIN, TRAIN_C4, INFER, INFER_C4])
def test_control_is_not_correct(workload, monkeypatch):
    """The float8 control (the reference in the program's place) fails a
    number of each cell; the float32 reference in the same place passes."""
    _reference_in_place(monkeypatch, None)
    assert run(workload)["correct"] is True
    _reference_in_place(monkeypatch, "fp8")
    r = run(workload)
    assert r["correct"] is False, r["compared"]


def test_fault_state_unchanged(monkeypatch):
    """A step that returns its state unchanged."""
    real = program.train_step

    def frozen(pcfg, model):
        step, opt = real(pcfg, model)
        monkeypatch.setattr(opt, "step", lambda *a, **k: None)
        return step, opt

    monkeypatch.setattr(program, "train_step", frozen)
    r = run(TRAIN)
    assert r["correct"] is False and r["compared"]["change_gap"]["value"] == 1.0


def test_fault_half_batch(monkeypatch):
    """Half of the batch left out, the losses the mean over the rest."""
    from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN

    real = GeneralizedRCNN.train_forward

    def half(self, batch, draws=None, generator=None):
        k = batch["images"].shape[0] // 2
        return real(self, {n: v[:k] for n, v in batch.items()},
                    {n: v[:k] for n, v in draws.items()}, generator)

    monkeypatch.setattr(GeneralizedRCNN, "train_forward", half)
    assert run(TRAIN)["correct"] is False


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
def test_fault_inference(fault, monkeypatch):
    """Half of the batch's detections left out; every label altered where
    the detections are produced."""
    real = program.eval_step

    def broken(model):
        step = real(model)

        def call(batch):
            out = dict(step(batch))
            if fault == "half_batch":
                keep = torch.arange(out["valid"].shape[0]) < out["valid"].shape[0] // 2
                out["valid"] = out["valid"] & keep[:, None]
            else:
                out["labels"] = out["labels"] % 4 + 1
            return out
        return call

    monkeypatch.setattr(program, "eval_step", broken)
    assert run(INFER)["correct"] is False


def _program_detector():
    from maskrcnn_tpu_torch.models import detector

    return detector


@pytest.mark.parametrize("fault", ["box_nms_skipped", "box_decode_perturbed"])
def test_fault_box_post_process(fault, monkeypatch):
    """The program's box post-process without its per-class NMS, or
    decoding with the wrong regression weights: detection_miss fails."""
    detector = _program_detector()
    real = detector.box_head_inference

    def broken(logits, reg, props, valid, sizes, weights, thresh, nms, per_img, **kw):
        if fault == "box_nms_skipped":
            nms = 1.01
        else:
            weights = (1.0, 1.0, 1.0, 1.0)
        return real(logits, reg, props, valid, sizes, weights, thresh, nms, per_img, **kw)

    monkeypatch.setattr(detector, "box_head_inference", broken)
    r = run(INFER)
    assert r["correct"] is False
    assert r["compared"]["detection_miss"]["value"] > r["compared"]["detection_miss"]["limit"]


@pytest.mark.parametrize("workload", [TRAIN, INFER_C4])
def test_fault_proposals_nms_skipped(workload, monkeypatch):
    """The program's proposal stage without its NMS: proposal_miss fails."""
    detector = _program_detector()
    real = detector.select_proposals

    def broken(anchors, obj, reg, sizes, rcfg, *args, **kwargs):
        rcfg = rcfg.clone()
        rcfg.defrost()
        rcfg.NMS_THRESH = 1.01
        return real(anchors, obj, reg, sizes, rcfg, *args, **kwargs)

    monkeypatch.setattr(detector, "select_proposals", broken)
    r = run(workload)
    assert r["correct"] is False
    assert r["compared"]["proposal_miss"]["value"] > r["compared"]["proposal_miss"]["limit"]


@pytest.mark.parametrize("workload,scale", [(TRAIN, 0.0), (TRAIN, 2.0), (TRAIN_C4, 0.0)])
def test_fault_pooler_backward(workload, scale, monkeypatch):
    """The program's ROI pooling passing none, or twice, of its gradient on
    to the features: grad_tail fails (the RPN's leaves do not see it)."""
    detector = _program_detector()
    real = detector.multilevel_roi_align

    class Scaled(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            return g * scale

    monkeypatch.setattr(detector, "multilevel_roi_align",
                        lambda f, *a, **k: real([Scaled.apply(x) for x in f], *a, **k))
    r = run(workload)
    assert r["correct"] is False
    c = r["compared"]
    assert c["grad_tail"]["value"] > c["grad_tail"]["limit"]
    assert c["rpn_grad_tail"]["value"] <= c["rpn_grad_tail"]["limit"]


def test_malformed_detections_counted():
    det = {"boxes": torch.tensor([[[0.0, 0.0, 10.0, 10.0], [5.0, 5.0, 4.5, 4.2]]]),
           "scores": torch.tensor([[0.5, 0.2]]), "labels": torch.tensor([[1, 2]]),
           "valid": torch.tensor([[True, True]]), "masks": torch.zeros(1, 2, 4, 4)}
    sizes = torch.tensor([[20, 20]])
    code = lambda d: cells.FAULTS[int(cells.malformed(d, sizes, 5)) - 1] \
        if int(cells.malformed(d, sizes, 5)) else None  # noqa: E731
    assert code(det) is None  # a box of width 0.5 (+1 convention)
    assert code(dict(det, boxes=det["boxes"] + torch.tensor([0.0, 0.0, 15.0, 0.0]))) == "box"
    assert code(dict(det, labels=torch.tensor([[0, 2]]))) == "label"
    outside = torch.tensor([[[0.0, 0.0, 10.0, 10.0], [5.0, 5.0, 30.0, 4.2]]])
    assert code(dict(det, boxes=outside)) == "box"
    assert code(dict(det, boxes=outside, valid=torch.tensor([[True, False]]))) is None
    assert code(dict(det, scores=torch.tensor([[float("nan"), 0.2]]))) == "non-finite"
    assert code(dict(det, masks=det["masks"] + 2)) == "probability out of [0, 1]"


def test_check_numbers():
    first = {"a": torch.ones(10), "rpn.w": torch.ones(10), "c": torch.ones(10)}
    props = (torch.tensor([[[0.0, 0.0, 9.0, 9.0], [2.0, 2.0, 5.0, 5.0]]]),
             torch.tensor([[0.9, 0.5]]), torch.tensor([[True, True]]))
    ref = {"losses": [1.0, 2.0], "grad": {"a": 1.0, "rpn.w": 2.0, "c": 3.0},
           "change": {"a": 1.0, "rpn.w": 1.0, "c": 1.0}, "first": first}
    prog = dict(ref, stages=[{"proposals": props}])
    same = check.train_numbers(prog, ref, [props])
    assert same == {"rpn_grad_tail": 0, "grad_tail": 0, "change_gap": 0, "proposal_miss": 0}
    moved = dict(prog, change={"a": 0.0, "rpn.w": 0.0, "c": 0.0},
                 first=dict(first, **{"rpn.w": torch.tensor([1.0] * 9 + [3.5]),
                                      "c": torch.tensor([1.0] * 8 + [3.5] * 2)}))
    shifted = (props[0] + torch.tensor([0.0, 0.0, 0.0, 0.5]), props[1], props[2])
    got = check.train_numbers(moved, ref, [shifted])
    assert got["change_gap"] == 1.0 and got["rpn_grad_tail"] == pytest.approx(0.1)
    assert got["grad_tail"] == pytest.approx(0.1) and got["proposal_miss"] == 1.0
    ok, compared = check.judge(got, {"change_gap": {"limit": 0.4}})
    assert not ok and list(compared) == ["change_gap"]


def test_misses_by_label_box_and_score():
    boxes = torch.tensor([[[0.0, 0.0, 9.0, 9.0], [2.0, 2.0, 5.0, 5.0], [1.0, 1.0, 3.0, 3.0]]])
    scores = torch.tensor([[0.9, 0.5, 0.1]])
    valid = torch.tensor([[True, True, False]])
    labels = torch.tensor([[1, 2, 3]])
    a = (boxes, scores, valid, labels)
    assert check.misses(a, a) == (0, 4)
    assert check.misses(a, (boxes, scores, valid, labels % 2 + 1)) == (4, 4)
    assert check.misses(a, (boxes, scores + 1e-3, valid, labels)) == (4, 4)
    assert check.misses(a, (boxes + 1e-3, scores, valid, labels)) == (0, 4)
    assert check.misses(a, (boxes, scores, torch.tensor([[True, False, False]]), labels)) == (1, 3)
