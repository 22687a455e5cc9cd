"""The readings that a cell's limits are set from, on the card, in one
process (the benchmark's own runs never run this):

    python3 benchmark/tools/readings.py --workload <name> --seeds 1 2 3 ... [--controls N]

For each seed it sets the cell up as a run does (the program's first steps,
or its first pass over the inference pool) and judges the program as a run
does (the lower readings). On the first N seeds it also judges the control,
the reference itself computed with float8 products in the program's place
(the upper readings), and the faults a cell can have. Training: a step on
half of each batch (the reference on the first half, its mean over those
images); the ROI pooling passing none of its gradient on to the features
(planted in the reference in the program's place; passing twice the
gradient reads the same, since the gap is the pooler's share either way);
the proposal stage without its NMS, over the program's RPN head outputs.
Inference: half of the images' detections left out; every label altered;
the box post-process without its per-class NMS, or decoding with the
regression weights (1, 1, 1, 1), over the program's box head outputs; the
proposal stage without its NMS. It prints one JSON line a seed and
reading, with diagnostics: the tails at several tolerances and the worst
leaves of a training number, and the program row's "counts", the
configuration's step_counts at the cell's first batch.

Every reading goes through the configuration's own reference module
(configs/<config>.json "reference"; spec.REFERENCE_API and TOOL_API) and
counts module, so a configuration's limits are set from its own reference.
"""

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from benchmark.harness import cells, check, spec  # noqa: E402


TOLS = (0.1, 0.3, 1.0, 3.0)
# what the faults need of a reference beyond spec.REFERENCE_API: its box
# post-process and proposal stage as functions, and its ops module, whose
# roi_align the pooler fault wraps
TOOL_API = ("box_head_inference", "select_proposals", "ops")


def worst_leaves(prog, ref, n=4):
    med = statistics.median(ref["grad"].values())
    rows = sorted(((abs(prog["grad"][k] - ref["grad"][k]) / max(ref["grad"][k], med), k)
                   for k in ref["grad"]), reverse=True)
    return [[k, v, prog["grad"][k], ref["grad"][k]] for v, k in rows[:n]]


def diagnostics(prog, ref):
    """Numbers beside the compared ones (PERF.md gives their readings):
    each step's total loss gap, the worst and the mean leaf's first-gradient
    norm gap, and the tails of the first gradient, RPN head and the rest,
    at several tolerances."""
    leaves = sorted(ref["grad"])
    g_med = statistics.median(ref["grad"].values())
    gaps = [abs(prog["grad"][k] - ref["grad"][k]) / max(ref["grad"][k], g_med) for k in leaves]
    rpn = [k for k in leaves if k.startswith(check.RPN_HEAD)]
    rest = [k for k in leaves if not k.startswith(check.RPN_HEAD)]

    def tails(keys):
        return {t: check.share([check.tail([prog["first"][k] for k in keys],
                                           [ref["first"][k] for k in keys], t)]) for t in TOLS}

    return {"loss_gaps": [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])],
            "grad_gap": max(gaps), "grad_mean_gap": statistics.mean(gaps),
            "rpn_tails": tails(rpn), "grad_tails": tails(rest)}


def infer_diagnostics(sides, refs):
    """The mask gaps' largest and mean, their shares past 0.005, 0.01 and
    0.02, and the RPN head's and box head's tails at several tolerances."""
    gaps = check.mask_gaps(sides, refs)
    return {"mask_gap": float(gaps.max()), "mask_mean_gap": float(gaps.mean()),
            "mask_tails": {t: float((gaps > t).mean()) for t in (0.005, 0.01, 0.02)},
            "rpn_tails": {t: check.share([check.tail(s["rpn"][0] + s["rpn"][1],
                                                     r["rpn"][0] + r["rpn"][1], t)
                                          for s, r in zip(sides, refs)]) for t in TOLS},
            "box_head_tails": {t: check.share([check.tail(s["box_head"], r["box_head"], t)
                                               for s, r in zip(sides, refs)]) for t in TOLS}}


class pooler_grad:
    """Within the block, the reference's ROI pooling (`ops`, the
    reference's ops module) passes `scale` times its gradient on to the
    features (0: a pooler backward that returns nothing), a fault planted
    in the reference put in the program's place."""

    def __init__(self, ops, scale):
        self.ops = ops
        self.scale = scale

    def __enter__(self):
        self.plain = self.ops.roi_align
        scale = self.scale

        class Scaled(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x.view_as(x)

            @staticmethod
            def backward(ctx, g):
                return g * scale

        plain = self.plain
        self.ops.roi_align = lambda f, *a, **k: plain([Scaled.apply(x) for x in f], *a, **k)

    def __exit__(self, *exc):
        self.ops.roi_align = self.plain


def train_seed(run, controls, precisions=("fp8",)):
    body = cells.TrainCell(run)
    body.free()
    st, pool = body.state, body.pool
    n = run.traffic["checked_steps"]
    t0 = time.perf_counter()
    numbers, ref = cells.judge_training(run, st, pool, body.readings)
    out = [("program", numbers,
            {"losses": body.readings["losses"], "ref_losses": ref["losses"],
             "reference_s": time.perf_counter() - t0, "worst": worst_leaves(body.readings, ref),
             "diag": diagnostics(body.readings, ref),
             "counts": run.counts(tuple(pool[0][0]["images"].shape[1:3]))})]
    if controls:
        sides = [("control_" + p, dict(precision=p), None) for p in precisions]
        sides += [("fault_half_batch", dict(half=True), None),
                  ("fault_pooler_backward_zeroed", {}, pooler_grad(run.ref.ops, 0.0))]
        for what, kwargs, fault in sides:
            if fault is not None:
                with fault:
                    side = cells.reference_train(run, st, pool, n, record=True, **kwargs)
            else:
                side = cells.reference_train(run, st, pool, n, record=True, **kwargs)
            got, ref = cells.judge_training(run, st, pool, side)
            out.append((what, got, {"losses": side["losses"], "worst": worst_leaves(side, ref),
                                    "diag": diagnostics(side, ref)}))
        # the proposal stage without its NMS, over the program's RPN head outputs
        cfg = cells.merged(run.cfg, {"MODEL": {"RPN": {"NMS_THRESH": 1.01}}})
        miss = []
        for i, s in enumerate(body.readings["stages"]):
            batch = cells.to_device(pool[i][0], run.device)
            good = run.ref.training_proposals(run.cfg, batch, s["rpn"])
            bad = run.ref.training_proposals(cfg, batch, s["rpn"])
            miss.append(check.share([check.misses(check._proposals(bad),
                                                  check._proposals(good))]))
        out.append(("fault_proposal_nms_skipped", {"proposal_miss": max(miss)}, {}))
    return out


def infer_seed(run, controls, precisions=("fp8",)):
    body = cells.InferCell(run)
    for _ in range(len(body.pool)):
        body.one()
    body.free()
    order = sorted(body.sample)
    batches = [body.pool[i] for i in order]
    prog = [body.kept[i] for i in order]
    t0 = time.perf_counter()
    sides, refs = cells.judge_detections(run, body.state, zip(batches, prog))
    tols = cells.tolerances(run.cell.limits)
    out = [("program", check.infer_numbers(sides, refs, tols),
            {"reference_s": time.perf_counter() - t0, "diag": infer_diagnostics(sides, refs),
             "counts": run.counts(tuple(body.pool[0]["images"].shape[1:3]))})]
    if not controls:
        return out
    for prec in precisions:
        ctl = cells.reference_stages(run, body.state, batches, prec)
        judged = cells.judge_detections(run, body.state, zip(batches, ctl))
        out.append(("control_" + prec, check.infer_numbers(*judged, tols),
                    {"diag": infer_diagnostics(*judged)}))
    h = run.cfg["MODEL"]["ROI_HEADS"]
    c = run.cfg["MODEL"]["ROI_BOX_HEAD"]["NUM_CLASSES"] - 1

    def post(side, b, **changed):
        """The box post-process of the side's own box head outputs, with
        `changed` in its configuration, its detections in the side's place."""
        dev = run.device
        det = run.ref.box_head_inference(
            *(t.to(dev) for t in side["box_head"]), side["proposals"][0].to(dev),
            side["proposals"][2].to(dev), b["image_sizes"].to(dev), dict(h, **changed),
            h["DETECTIONS_PER_IMG"])
        det = {k: v.cpu() for k, v in det.items()}
        return dict(side, detections=dict(det, masks=side["detections"]["masks"]))

    def proposals_without_nms(side, b):
        model = run.ref.MaskRCNN(cells.merged(run.cfg, {"MODEL": {"RPN": {"NMS_THRESH": 1.01}}}))
        feats = [o.to(run.device) for o in side["rpn"][0]]
        grids = [model.anchors.grid(l, o.shape[2], o.shape[3], run.device)
                 for l, o in enumerate(feats)]
        props = run.ref.select_proposals(
            grids, feats, [r.to(run.device) for r in side["rpn"][1]],
            b["image_sizes"].to(run.device), model.cfg["MODEL"]["RPN"], False)
        return dict(side, proposals=tuple(t.cpu() for t in props))

    faults = {
        "fault_half_batch": [dict(s, detections=dict(s["detections"], valid=s["detections"][
            "valid"] & (torch.arange(s["detections"]["valid"].shape[0]) % 2 == 0)[:, None]))
            for s in prog],
        "fault_answer_altered": [dict(s, detections=dict(s["detections"], labels=s[
            "detections"]["labels"] % c + 1)) for s in prog],
        "fault_box_nms_skipped": [post(s, b, NMS=1.01) for s, b in zip(prog, batches)],
        "fault_box_decode_perturbed": [post(s, b, BBOX_REG_WEIGHTS=[1.0, 1.0, 1.0, 1.0])
                                       for s, b in zip(prog, batches)],
        "fault_proposal_nms_skipped": [proposals_without_nms(s, b)
                                       for s, b in zip(prog, batches)],
    }
    for what, side in faults.items():
        out.append((what, check.infer_numbers(
            *cells.judge_detections(run, body.state, zip(batches, side)), tols), {}))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--precisions", nargs="+", default=["fp8"])
    p.add_argument("--program-dtype", default=None,
                   help="run the program at this TPU.COMPUTE_DTYPE (a diagnostic), TF32 off")
    args = p.parse_args(argv)
    over = None
    if args.program_dtype:
        over = {"config": {"TPU": {"COMPUTE_DTYPE": args.program_dtype}}}
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cell = spec.Cell(spec.benchmark(), args.workload)
    spec.part(cell.config, "reference", spec.REFERENCE_API + TOOL_API)
    for k, seed in enumerate(args.seeds):
        run = cells.Run(cell, seed, "cuda", over)
        t0 = time.perf_counter()
        rows = (train_seed if run.kind == "train" else infer_seed)(run, k < args.controls,
                                                                   args.precisions)
        for what, numbers, extra in rows:
            print(json.dumps({"workload": args.workload, "seed": seed, "what": what,
                              "numbers": numbers, "seconds": time.perf_counter() - t0, **extra}),
                  flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
