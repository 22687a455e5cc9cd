"""One run of one cell: set-up, the measured or traced window, the check.

Training cells drive engine.make_train_step through their first
traffic["checked_steps"] steps on distinct batches (set-up, which also
builds every kernel and warms every shape), keep the readings that the
check compares with the program's proposal stage at each step
(program.capture), and hand that same step to the window. Inference cells
run engine.make_eval_step closed-loop, one batch in flight, and keep the
host detections and the recorded stages of sampled batches; every batch's
host detections are checked for malformed values as they come.
After the window the program is freed and the float32 reference
recomputes the same steps or batches from the same inputs and weights,
following the program's proposals (check.py says why).
"""

import copy
import gc
import time

import numpy as np
import torch

from . import check, program, traffic as gen, weights
from ..reference import solver as ref_solver

GIB = float(1 << 30)


def merged(base, extra):
    """Deep copy of nested dict `base` with `extra`'s leaves on top."""
    out = copy.deepcopy(base)
    for k, v in (extra or {}).items():
        out[k] = merged(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


class Run:
    """The parts of a run: the cell, its seed, the device, and the
    configuration as data (`cfg`, what the reference reads) and as the
    program's CfgNode (`pcfg`), both from the cell's configuration file
    (and, in tests, the same overrides). `ref` is the configuration's
    reference module (spec.REFERENCE_API), the one way in to the
    reference."""

    def __init__(self, cell, seed, device, overrides=None):
        overrides = overrides or {}
        self.cell = cell
        self.ref = cell.reference
        self.seed = int(seed)
        self.device = torch.device(device)
        self.cfg = merged(cell.config["config"], overrides.get("config"))
        self.pcfg = program.program_cfg(cell.config, overrides.get("config"))
        self.traffic = merged(cell.traffic, overrides.get("traffic"))
        self.kind = self.traffic["kind"]
        self.init = overrides.get("init", []) + cell.config["init"]

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def reference(self, state, precision=None, cfg=None):
        """The reference model of `cfg` (the run's own by default) holding
        `state`, at `precision` (None: float32)."""
        model = self.ref.MaskRCNN(self.cfg if cfg is None else cfg).to(self.device)
        model.load_state_dict(state, strict=True)
        self.ref.set_precision(model, precision)
        return model

    def make_state(self, first_batch):
        """The benchmark's weights: drawn from the seed on the device, then
        the body's normalisation set by the float32 reference from the
        cell's first batch (on the device)."""
        shapes = program.state_shapes(self.pcfg)
        state = weights.seeded_state(shapes, self.init, self.seed, self.device)
        with float32_matmuls():
            model = self.reference(state)
            self.ref.calibrate(model, first_batch)
            state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del model
        return state

    def counts(self, hw):
        """The configuration's counts of one step at images padded to hw
        (its counts module's step_counts)."""
        return self.cell.counts.step_counts(self.cfg, self.traffic["batch"], hw,
                                            self.kind == "train")


class float32_matmuls:
    """TF32 off for the reference's float32 products, restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def _leaf_norms(tensors):
    names = sorted(tensors)
    if not names:
        return {}
    norms = torch.stack([tensors[k].detach().float().norm() for k in names]).tolist()
    return dict(zip(names, norms))


# -- training -----------------------------------------------------------------------


def train_readings(step, optimizer, params, state, pool, n):
    """Drive `step` through the first n batches of the pool: {"losses":
    [total per step], "grad": {leaf: norm of the momentum buffer after step
    1}, "first": {leaf: that buffer, on the host}, "change": {leaf: norm of
    its change after step n}}."""
    losses, terms, grad = [], [], None
    for i in range(n):
        batch, draws = pool[i]
        out = step(batch, draws)
        terms.append({k: float(v) for k, v in out.items()})
        losses.append(terms[-1]["loss"])
        if i == 0:
            # no buffer: the optimizer never stepped (a state left unchanged)
            first = {k: optimizer.state[p].get("momentum_buffer", torch.zeros_like(p))
                     for k, p in params.items()}
            grad = _leaf_norms(first)
            first = {k: v.detach().to("cpu", torch.float32, copy=True) for k, v in first.items()}
    change = _leaf_norms({k: p.detach() - state[k] for k, p in params.items()})
    return {"losses": losses, "terms": terms, "grad": grad, "change": change, "first": first}


def reference_train(run, state, pool, n, precision=None, half=False, forced=None, record=False):
    """The same readings from the reference's steps (float32, or
    `precision`; half=True: the first half of each batch only, a fault).
    forced: each step's (boxes, valid) proposals, taken in place of the
    reference's own; record: add "stages", each step's proposal stage, as
    program.capture records the program's."""
    with float32_matmuls():
        model = run.reference(state, precision)
        opt, sched = ref_solver.make_sgd(run.cfg["SOLVER"], model)
        cap = run.cfg["TPU"]["MASK_ROI_CAP"]
        stages = []

        def step(batch, draws):
            if half:
                k = batch["images"].shape[0] // 2
                batch = {key: v[:k] for key, v in batch.items()}
                draws = {key: v[:k] for key, v in draws.items()}
            at = forced[len(stages)] if forced is not None else None
            rec = {}
            losses = model.train_forward(batch, draws, cap, at, rec)
            stages.append(rec if record else None)
            total = sum(losses.values())
            opt.zero_grad(set_to_none=True)
            total.backward()
            opt.step()
            sched.step()
            return dict({k: v.detach() for k, v in losses.items()}, loss=total.detach())

        params = {k: p for k, p in model.named_parameters() if p.requires_grad}
        out = train_readings(step, opt, params, state, pool, n)
    if record:
        out["stages"] = stages
    del model, opt
    return out


def judge_training(run, state, pool, side, **kwargs):
    """{number: value} of a side's training readings (with "stages"): the
    float32 reference taking the side's proposals at each step, and the
    reference's proposal stage over the side's RPN head outputs."""
    forced = [(s["proposals"][0], s["proposals"][2]) for s in side["stages"]]
    ref = reference_train(run, state, pool, len(forced), forced=forced, **kwargs)
    props = [run.ref.training_proposals(run.cfg, to_device(pool[i][0], run.device), s["rpn"])
             for i, s in enumerate(side["stages"])]
    return check.train_numbers(side, ref, props, tolerances(run.cell.limits)), ref


class TrainCell:
    def __init__(self, run):
        self.run = run
        r = run
        self.pool = gen.train_pool(r.traffic, r.cfg, r.seed, r.device)
        self.state = r.make_state(self.pool[0][0])
        self.model = program.build_model(r.pcfg, self.state, r.device)
        self.step, self.optimizer = program.train_step(r.pcfg, self.model)
        params = {k: p for k, p in self.model.named_parameters() if p.requires_grad}
        with program.capture() as cap:
            self.readings = train_readings(self.step, self.optimizer, params, self.state,
                                           self.pool, r.traffic["checked_steps"])
        self.readings["stages"] = cap.stages(r.traffic["checked_steps"])
        r.sync()
        self.next = r.traffic["checked_steps"]
        self.attempted = self.failed = 0

    def one(self, _=None):
        batch, draws = self.pool[self.next % len(self.pool)]
        self.next += 1
        return self.step(batch, draws)["loss"]

    def window(self, seconds):
        """Steps back to back until `seconds` have passed, then wait for the
        device: (images trained, the whole window's seconds)."""
        r = self.run
        losses = []
        r.sync()
        t0 = time.perf_counter()
        while True:
            losses.append(self.one())
            if time.perf_counter() - t0 >= seconds:
                break
        r.sync()
        wall = time.perf_counter() - t0
        self.attempted = len(losses)
        self.failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return len(losses) * r.traffic["batch"], wall

    def traced(self, window):
        losses = []
        reading = window.run(lambda i: losses.append(self.one()), self.run.traffic["trace_steps"])
        self.attempted = len(losses)
        self.failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return reading

    def free(self):
        del self.model, self.step, self.optimizer
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_numbers(self):
        return judge_training(self.run, self.state, self.pool, self.readings)[0]


def tolerances(limits):
    """{number: tolerance} of the numbers whose limits file gives one."""
    return {k: v["tolerance"] for k, v in limits["numbers"].items() if "tolerance" in v}


# -- inference ------------------------------------------------------------------------

DET_KEYS = ("boxes", "scores", "labels", "valid", "masks")


def to_device(batch, device):
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def host_detections(out):
    return {k: out[k].cpu() for k in DET_KEYS}


FAULTS = ("non-finite", "probability out of [0, 1]", "label", "box")


def malformed(det, image_sizes, num_classes):
    """0 where a batch's host detections keep their contract, else 1 + the
    index in FAULTS of the first they break: finite values, scores and mask
    probabilities in [0, 1], valid labels of a class, valid boxes inside
    their image with a width and height of at least 0 (x2 - x1 + 1 >= 0,
    the boxes' +1 convention). Plain numpy: no kernel launch, no host
    thread pool beside the program's."""
    v = det["valid"].numpy()
    boxes, scores, masks = (det[k].float().numpy() for k in ("boxes", "scores", "masks"))
    labels = det["labels"].numpy()
    hw = image_sizes.numpy()[:, None, :].astype(np.float32)
    inside = ((boxes[..., 0] >= 0) & (boxes[..., 1] >= 0) & (boxes[..., 2] <= hw[..., 1] - 1)
              & (boxes[..., 3] <= hw[..., 0] - 1) & (boxes[..., 2] >= boxes[..., 0] - 1)
              & (boxes[..., 3] >= boxes[..., 1] - 1))
    checks = (lambda: np.isfinite(boxes).all() and np.isfinite(scores).all()
              and np.isfinite(masks).all(),
              lambda: masks.min() >= 0 and masks.max() <= 1 and scores.min() >= 0
              and scores.max() <= 1,
              lambda: not (v & ~((labels >= 1) & (labels < num_classes))).any(),
              lambda: not (v & ~inside).any())
    return next((k + 1 for k, ok in enumerate(checks) if not ok()), 0)


class InferCell:
    def __init__(self, run):
        self.run = run
        r = run
        self.pool = gen.infer_pool(r.traffic, r.cfg, r.seed, r.device)
        self.state = r.make_state(to_device(self.pool[0], r.device))
        self.model = program.build_model(r.pcfg, self.state, r.device)
        self.estep = program.eval_step(self.model)
        self.classes = r.cfg["MODEL"]["ROI_BOX_HEAD"]["NUM_CLASSES"]
        seen = set()
        for batch in self.pool:  # every shape of the pool, twice
            shape = tuple(batch["images"].shape)
            if shape not in seen:
                seen.add(shape)
                for _ in range(2):
                    host_detections(self.estep(to_device(batch, r.device)))
        # the sample: checked_batches of the first trace_batches, which every
        # run completes, traced or not
        rs = np.random.RandomState(gen.sub_seeds(r.seed, 3)[2])
        first = min(len(self.pool), r.traffic["trace_batches"])
        self.sample = set(int(i) for i in rs.choice(first, r.traffic["checked_batches"],
                                                    replace=False))
        self.kept = {}
        self.next = 0
        self.latencies = []
        self.codes = []

    def one(self, _=None):
        i = self.next
        batch = self.pool[i % len(self.pool)]
        t0 = time.perf_counter()
        if i in self.sample:
            with program.capture(on_device=True) as cap:
                out = self.estep(to_device(batch, self.run.device))
                det = host_detections(out)
            self.kept[i] = dict(cap.stages(1)[0], detections=det)
        else:
            out = self.estep(to_device(batch, self.run.device))
            det = host_detections(out)
        self.latencies.append(time.perf_counter() - t0)
        self.next += 1
        sizes = batch["image_sizes"]
        if det["boxes"].shape != sizes.shape[:1] + det["scores"].shape[1:] + (4,):
            raise RuntimeError("detections of shape {}".format(tuple(det["boxes"].shape)))
        # checked on the host copies after the batch's time is taken, inside
        # the window: holding every batch's copies for a check after it
        # read 7-23% slower on the card (PERF.md)
        self.codes.append(malformed(det, sizes, self.classes))

    def window(self, seconds):
        """Closed loop, one batch in flight, until `seconds` have passed and
        the sampled batches are done: (images whose detections reached the
        host, the window's seconds)."""
        t0 = time.perf_counter()
        last = max(self.sample)
        while True:
            self.one()
            if time.perf_counter() - t0 >= seconds and self.next > last:
                break
        wall = time.perf_counter() - t0
        return self.next * self.run.traffic["batch"], wall

    def traced(self, window):
        return window.run(self.one, self.run.traffic["trace_batches"])

    @property
    def attempted(self):
        return self.next

    @property
    def failed(self):
        return sum(1 for c in self.codes if c)

    @property
    def faults(self):
        """{fault: batches} of the malformed batches."""
        return {FAULTS[c - 1]: self.codes.count(c) for c in set(self.codes) if c}

    def free(self):
        self.kept = {i: program.copied(k) for i, k in self.kept.items()}
        del self.model, self.estep
        gc.collect()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_numbers(self):
        missing = self.sample - set(self.kept)
        if missing:
            raise RuntimeError("sampled batches {} did not complete".format(sorted(missing)))
        return check.infer_numbers(*judge_detections(
            self.run, self.state, [(self.pool[i], self.kept[i]) for i in sorted(self.sample)]),
            tolerances(self.run.cell.limits))


def judge_detections(run, state, pairs):
    """(sides, refs) for pairs [(host batch, the stages of its inference on
    the side judged)]: the float32 reference's counterpart of each stage
    (reference MaskRCNN.judge)."""
    sides, refs = [], []
    with float32_matmuls():
        model = run.reference(state)
        for batch, side in pairs:
            sides.append(side)
            refs.append(model.judge(to_device(batch, run.device), side))
    del model
    return sides, refs


def reference_stages(run, state, batches, precision=None, overrides=None):
    """The stages of the reference's inference of each host batch, at
    `precision` and under configuration `overrides` (the control, or a
    fault, in the program's place), detections on the host."""
    out = []
    with float32_matmuls():
        model = run.reference(state, precision, merged(run.cfg, overrides))
        for b in batches:
            rec = {}
            det = model.infer_forward(to_device(b, run.device), record=rec)
            out.append(dict(rec, detections=host_detections(det)))
    del model
    return out
