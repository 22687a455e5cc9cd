"""What decides ``correct``: the program's outputs against the float32
reference's, number by number, each under its limit (limits/<cell>.json,
with the readings each limit was set from; PERF.md says why these numbers).

With random weights every anchor and class scores within rounding of its
neighbours, so the top-k and NMS stages reorder under any rounding and two
whole runs share few proposals. The reference therefore follows the
program stage by stage: each stage is judged against the reference's from
that stage's own input on the program's side (the program's RPN head
outputs, proposals, box head outputs and detections, recorded by
program.capture), and the stages that compute (the body, the heads, the
backward) against the reference's own features.

Training: the checked set-up steps, the reference taking the program's
proposals at each:
* ``rpn_grad_tail``: the share of the RPN head's first-gradient elements
  (SGD's momentum buffer after one step: the gradient plus weight decay)
  that differ from the reference's by more than a tolerance (GRAD_TAIL, or
  the cell's limits file's "tolerance") times the RMS of their leaf;
* ``grad_tail``: the same share over every other leaf: the body and FPN
  (reached by the RPN's and, through the pooler's backward, the ROI heads'
  gradients) and the box and mask heads;
* ``change_gap``: each leaf's change over the checked steps, the largest
  gap of its norm on the two sides over the reference leaf's norm or the
  median leaf's, whichever is larger, leaving out the leaves whose
  reference gradient is under a thousandth of the median leaf's (round-off
  moves them under momentum alone);
* ``proposal_miss``: the proposal stage by itself: the share of the
  program's proposals and the reference's, over the program's own RPN head
  outputs, that the other side lacks (the worst step).

Inference: sampled batches, image by image:
* ``rpn_tail``: the share of the RPN head's outputs that differ from the
  reference's by more than a tolerance (FWD_TAIL, or the cell's limits
  file's "tolerance") times the RMS of their level's tensor;
* ``proposal_miss``: as in training, over the program's RPN head outputs;
* ``box_head_tail``: the share of the box head's class logits and box
  regression at the program's proposals that differ from the reference's
  at the same proposals by more than a tolerance times their tensor's RMS;
* ``detection_miss``: the share of the program's detections and the
  reference box post-process's (decode, clip, per-class NMS, top-k) over the
  program's box head outputs that the other side lacks;
* ``mask_tail``: the share of the valid detections' mask pixels whose
  probability differs by more than MASK_TAIL from the reference's mask
  head at that detection's own box and label.

Two proposals or detections are the same where their label is, every
coordinate lies within SAME_BOX pixels and the score within SAME_SCORE.
"""

import statistics

import numpy as np
import torch

RPN_HEAD = "rpn."
GRAD_TAIL = 1.0  # a first-gradient element's gap, in RMS of its leaf
FWD_TAIL = 0.3  # a head output's gap, in RMS of its tensor
MASK_TAIL = 0.02  # a mask pixel's probability gap
SAME_BOX = 1e-2  # pixels
SAME_SCORE = 1e-5


def leaf_gap(prog, ref, leaves):
    """The largest gap of a leaf's norm on the two sides over the
    reference leaf's norm or the median leaf's, whichever is larger."""
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves)


def tail(prog, ref, tol):
    """(elements past tol x their tensor's RMS, elements) over the paired
    tensors of the lists prog and ref."""
    past = total = 0
    for p, r in zip(prog, ref):
        r = r.detach().to("cpu", torch.float32)
        p = p.detach().to("cpu", torch.float32)
        rms = r.pow(2).mean().sqrt().clamp(min=1e-30)
        past += int(((p - r).abs() > tol * rms).sum())
        total += r.numel()
    return past, total


def share(counts):
    past = sum(c[0] for c in counts)
    total = sum(c[1] for c in counts)
    return past / total if total else 0.0


def misses(a, b):
    """(rows that the other side lacks, rows) over the valid rows of two
    sides' per-image lists: a and b are (boxes [B, N, 4], scores [B, N],
    valid [B, N], labels [B, N] or None); worked out on b's device."""
    missed = total = 0
    dev = b[0].device
    for i in range(a[0].shape[0]):
        rows = []
        for boxes, scores, valid, labels in (a, b):
            v = valid[i].to(dev, torch.bool)
            rows.append((boxes[i].to(dev, torch.float64)[v],
                         scores[i].to(dev, torch.float64)[v],
                         None if labels is None else labels[i].to(dev, torch.int64)[v]))
        (ba, sa, la), (bb, sb, lb) = rows
        same = (sa[:, None] - sb[None, :]).abs() <= SAME_SCORE
        for c in range(4):
            same &= (ba[:, None, c] - bb[None, :, c]).abs() <= SAME_BOX
        if la is not None:
            same &= la[:, None] == lb[None, :]
        missed += int((~same.any(1)).sum()) + int((~same.any(0)).sum())
        total += ba.shape[0] + bb.shape[0]
    return missed, total


def _proposals(p):
    boxes, scores, valid = p
    return boxes, scores, valid, None


def _detections(d):
    return d["boxes"], d["scores"], d["valid"], d["labels"]


def train_numbers(prog, ref, ref_proposals, tolerances=None):
    """prog, ref: {"losses": [total per step], "grad": {leaf: norm},
    "change": {leaf: norm}, "first": {leaf: first gradient}}, the program's
    with "stages" (its proposal stage at each checked step); ref_proposals:
    the reference's proposal stage over each step's program RPN head
    outputs; tolerances: {number: tolerance} in place of GRAD_TAIL ->
    {number: value}."""
    tol = dict({"rpn_grad_tail": GRAD_TAIL, "grad_tail": GRAD_TAIL}, **(tolerances or {}))
    leaves = sorted(ref["grad"])
    g_med = statistics.median(ref["grad"][k] for k in leaves)
    moving = [k for k in leaves if ref["grad"][k] >= 1e-3 * g_med]
    rpn = [k for k in leaves if k.startswith(RPN_HEAD)]
    rest = [k for k in leaves if not k.startswith(RPN_HEAD)]
    return {
        "rpn_grad_tail": share([tail([prog["first"][k] for k in rpn],
                                     [ref["first"][k] for k in rpn], tol["rpn_grad_tail"])]),
        "grad_tail": share([tail([prog["first"][k] for k in rest],
                                 [ref["first"][k] for k in rest], tol["grad_tail"])]),
        "change_gap": leaf_gap(prog["change"], ref["change"], moving),
        "proposal_miss": max(share([misses(_proposals(s["proposals"]), _proposals(r))])
                             for s, r in zip(prog["stages"], ref_proposals)),
    }


def mask_gaps(sides, refs):
    """Every valid judged detection's mask pixels' gaps to the reference's
    masks at the same boxes and labels, one array."""
    gaps = [np.zeros(0)]
    for s, r in zip(sides, refs):
        v = s["detections"]["valid"].numpy().astype(bool)
        gaps.append(np.abs(s["detections"]["masks"].float().numpy()[v].astype(np.float64)
                           - r["masks"].float().cpu().numpy()[v].astype(np.float64)).reshape(-1))
    return np.concatenate(gaps)


def infer_numbers(sides, refs, tolerances=None):
    """sides: each sampled batch's stages on the side judged ("rpn",
    "proposals" and "box_head" as program.capture records them, and
    "detections": its host detections with their masks); refs: the
    reference's counterparts (reference MaskRCNN.judge); tolerances:
    {number: tolerance} in place of FWD_TAIL -> {number: value}."""
    tol = dict({"rpn_tail": FWD_TAIL, "box_head_tail": FWD_TAIL}, **(tolerances or {}))
    gaps = mask_gaps(sides, refs)
    return {
        "rpn_tail": share([tail(s["rpn"][0] + s["rpn"][1], r["rpn"][0] + r["rpn"][1],
                                tol["rpn_tail"])
                           for s, r in zip(sides, refs)]),
        "proposal_miss": share([misses(_proposals(s["proposals"]), _proposals(r["proposals"]))
                                for s, r in zip(sides, refs)]),
        "box_head_tail": share([tail(s["box_head"], r["box_head"], tol["box_head_tail"])
                                for s, r in zip(sides, refs)]),
        "detection_miss": share([misses(_detections(s["detections"]),
                                        _detections(r["detections"]))
                                 for s, r in zip(sides, refs)]),
        "mask_tail": float((gaps > MASK_TAIL).mean()) if gaps.size else 0.0,
    }


def judge(numbers, limits):
    """(correct, {number: [value, limit]}) over the numbers that `limits`
    names: correct when each is at most its limit; a number without a limit
    is never correct."""
    compared = {}
    ok = True
    for k in limits:
        v, lim = numbers[k], limits[k].get("limit")
        compared[k] = [v, lim]
        ok = ok and lim is not None and np.isfinite(v) and v <= lim
    return bool(ok), compared
