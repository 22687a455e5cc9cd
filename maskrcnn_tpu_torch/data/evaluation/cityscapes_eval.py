"""Cityscapes instance-level evaluation (AP / AP50 / AP75 per class).

Port copy of maskrcnn_tpu/data/evaluation/cityscapes_eval.py. The one
change: predicted masks are pasted into the image by the native paste of
utils/maskops.py (the COCO evaluator's), where the JAX package calls its
OpenCV Masker; the two agree but for pixels whose probability sits at the
threshold.

Reference: maskrcnn_benchmark/data/datasets/evaluation/cityscapes/
{cityscapes_eval.py,eval_instances.py} (itself derived from the official
cityscapesScripts evalInstanceLevelSemanticLabeling). This is a fresh
implementation of the same metric with a flat match table instead of the
reference's nested per-instance dict copies:

  stage 1 (match): for every image, every (gt, pred) pair of ANY class with
    overlapping boxes records (box_intersection, mask_intersection).
  stage 2 (score): per metric in {box, mask}, per class x overlap-threshold
    x min-region-size cell, build the y_true/y_score vectors with the
    reference's exact conventions — duplicate matches of one gt demote the
    lower-scored prediction to a false positive; unmatched gts are hard
    false negatives; unmatched predictions are ignored when mostly covered
    by under-sized gts — then integrate the step-wise PR curve.

Semantics quirks preserved on purpose:
  * boxes are truncated to int before areas/intersections (bbs.long())
  * a gt's pixelCount counts only pixels inside its own (truncated) bbox
  * predictions with an all-empty pasted mask are dropped entirely (for the
    box metric too) whenever masks are being evaluated
  * matching candidates are pairs with box_intersection > 0 of any class
    combination, but scoring is per-class
  * AP averages (nanmean) skip classes that never appear, including the
    __background__ row.
"""

import json
import logging
import os

import numpy as np

from ...utils import maskops

OVERLAPS = np.arange(0.5, 1.0, 0.05)
MIN_REGION_SIZES = (100,)


def _int_box(box):
    return tuple(int(v) for v in box)


def _box_intersection(a, b):
    x0 = max(a[0], b[0])
    y0 = max(a[1], b[1])
    x1 = min(a[2], b[2])
    y1 = min(a[3], b[3])
    return (x1 - x0) * (y1 - y0)


def _boxes_overlap(a, b):
    return a[0] < b[2] and b[0] < a[2] and a[1] < b[3] and b[1] < a[3]


def _mask_intersection(gt_mask, pred_mask, a, b):
    if gt_mask is None or pred_mask is None:
        return 0
    x0 = min(a[0], b[0])
    y0 = min(a[1], b[1])
    x1 = max(a[2], b[2])
    y1 = max(a[3], b[3])
    g = gt_mask[y0:y1, x0:x1]
    p = pred_mask[y0:y1, x0:x1]
    return int(np.count_nonzero(np.logical_and(g, p)))


class _Inst:
    __slots__ = ("label", "box", "box_area", "pixel_count", "score", "matches")

    def __init__(self, label, box, box_area, pixel_count, score=None):
        self.label = label
        self.box = box
        self.box_area = box_area
        self.pixel_count = pixel_count
        self.score = score
        self.matches = []  # (other _Inst, box_intersection, mask_intersection)


def _gt_instances(dataset, idx):
    """Ground-truth _Inst list + binary masks at original resolution."""
    _, target, _ = dataset[idx]
    info = dataset.get_img_info(idx)
    size = (info["width"], info["height"])
    if len(target) == 0:
        return []
    if target.size != size:
        target = target.resize(size)
    target = target.convert("xyxy")
    masks = None
    if target.has_field("masks"):
        m = target.get_field("masks").get_mask_tensor()
        masks = m[None] if m.ndim == 2 else m
    out = []
    labels = np.asarray(target.get_field("labels")).astype(int)
    for i in range(len(target)):
        box = _int_box(target.bbox[i])
        pix = 0
        mask = None
        if masks is not None:
            mask = np.asarray(masks[i])
            pix = int(mask[box[1]:box[3], box[0]:box[2]].sum())
        inst = _Inst(
            labels[i], box, (box[2] - box[0]) * (box[3] - box[1]), pix
        )
        out.append((inst, mask))
    return out


def _pred_instances(dataset, prediction, idx, masker):
    info = dataset.get_img_info(idx)
    size = (info["width"], info["height"])
    if len(prediction) == 0:
        return []
    if prediction.size != size:
        prediction = prediction.resize(size)
    prediction = prediction.convert("xyxy")
    labels = np.asarray(prediction.get_field("labels")).astype(int)
    scores = np.asarray(prediction.get_field("scores")).astype(float)
    masks = None
    if prediction.has_field("mask"):
        m = np.asarray(prediction.get_field("mask"), np.float32)
        masks = masker(m, prediction)  # [N, H, W] {0,1}
    out = []
    for i in range(len(prediction)):
        box = _int_box(prediction.bbox[i])
        mask = None
        pix = 0
        if masks is not None:
            mask = masks[i]
            pix = int(mask[box[1]:box[3], box[0]:box[2]].sum())
            if pix == 0:
                continue  # reference drops empty-mask predictions outright
        inst = _Inst(
            labels[i], box, (box[2] - box[0]) * (box[3] - box[1]), pix,
            scores[i],
        )
        out.append((inst, mask))
    return out


def _default_masker(mask_probs, boxlist):
    """Paste [N, M, M] (or [N,1,M,M]) mask probs into full-image binaries."""
    m = np.asarray(mask_probs, np.float32)
    if m.ndim == 4:
        m = m[:, 0]
    w, h = boxlist.size
    boxes = np.asarray(boxlist.convert("xyxy").bbox, np.float64)
    out = np.zeros((len(boxes), h, w), np.uint8)
    for i in range(len(boxes)):
        out[i] = maskops.decode_rle(maskops.paste_encode_mask(m[i], boxes[i], h, w))
    return out


def match_gts_with_preds(dataset, predictions, masker=_default_masker):
    """Per image: ([gt _Inst], [pred _Inst]) with cross matches filled in."""
    assert len(dataset) == len(predictions), (
        f"{len(dataset)} != {len(predictions)}"
    )
    matches = []
    for idx in range(len(predictions)):
        gts = _gt_instances(dataset, idx)
        preds = _pred_instances(dataset, predictions[idx], idx, masker)
        for gt, gt_mask in gts:
            for pred, pred_mask in preds:
                if not _boxes_overlap(gt.box, pred.box):
                    continue
                bi = _box_intersection(gt.box, pred.box)
                if bi <= 0:
                    continue
                mi = _mask_intersection(gt_mask, pred_mask, gt.box, pred.box)
                gt.matches.append((pred, bi, mi))
                pred.matches.append((gt, bi, mi))
        matches.append(([g for g, _ in gts], [p for p, _ in preds]))
    return matches


def _area(inst, metric):
    return inst.box_area if metric == "box" else inst.pixel_count


def _intersection(pair, metric):
    return pair[1] if metric == "box" else pair[2]


def _ap_from_curve(y_true, y_score, hard_fns):
    order = np.argsort(y_score)
    score_sorted = y_score[order]
    true_sorted = y_true[order]
    cum = np.cumsum(true_sorted)
    thresholds, first_idx = np.unique(score_sorted, return_index=True)
    n = len(score_sorted)
    n_true = cum[-1] if n else 0
    cum = np.append(cum, 0)  # index -1 -> zero (first threshold)
    precision = np.zeros(len(first_idx) + 1)
    recall = np.zeros(len(first_idx) + 1)
    for row, i in enumerate(first_idx):
        below = cum[i - 1]
        tp = n_true - below
        fp = n - i - tp
        fn = below + hard_fns
        precision[row] = tp / (tp + fp)
        recall[row] = tp / (tp + fn)
    precision[-1] = 1.0
    recall[-1] = 0.0
    # step-wise integration: width of step i = (r[i-1] - r[i+1]) / 2 with
    # duplicated first point and trailing 0 (the reference's convolution)
    padded = np.concatenate([[recall[0]], recall, [0.0]])
    widths = np.convolve(padded, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, widths))


def evaluate_matches(matches, class_names, metric):
    """AP matrix [len(MIN_REGION_SIZES), num classes, len(OVERLAPS)]."""
    ap = np.zeros((len(MIN_REGION_SIZES), len(class_names), len(OVERLAPS)))
    for di, min_region in enumerate(MIN_REGION_SIZES):
        for oi, th in enumerate(OVERLAPS):
            for li, _ in enumerate(class_names):
                y_true, y_score = [], []
                hard_fns = 0
                have_gt = have_pred = False
                for gts, preds in matches:
                    cls_gts = [
                        g for g in gts
                        if g.label == li and _area(g, metric) >= min_region
                    ]
                    cls_preds = [p for p in preds if p.label == li]
                    have_gt |= bool(cls_gts)
                    have_pred |= bool(cls_preds)

                    for gt in cls_gts:
                        best = None
                        # NOTE: like the reference (eval_instances.py:483),
                        # candidate predictions are NOT class-filtered here —
                        # the per-class bucketing applies to the outer
                        # instance lists only.
                        for pair in gt.matches:
                            pred = pair[0]
                            inter = _intersection(pair, metric)
                            denom = (
                                _area(gt, metric) + _area(pred, metric) - inter
                            )
                            if denom <= 0 or inter / denom <= th:
                                continue
                            s = pred.score
                            if best is None:
                                best = s
                            else:
                                # second match of the same gt: the lower
                                # score becomes a false positive
                                lo, best = min(best, s), max(best, s)
                                y_true.append(0)
                                y_score.append(lo)
                        if best is None:
                            hard_fns += 1
                        else:
                            y_true.append(1)
                            y_score.append(best)

                    for pred in cls_preds:
                        matched = False
                        # as above: candidate gts are not class-filtered
                        for pair in pred.matches:
                            gt = pair[0]
                            inter = _intersection(pair, metric)
                            denom = (
                                _area(gt, metric) + _area(pred, metric) - inter
                            )
                            if denom > 0 and inter / denom > th:
                                matched = True
                                break
                        if matched:
                            continue
                        ignore_inter = sum(
                            _intersection(pair, metric)
                            for pair in pred.matches
                            if _area(pair[0], metric) < min_region
                        )
                        area = _area(pred, metric)
                        ignored = area > 0 and ignore_inter / area > th
                        if not ignored:
                            y_true.append(0)
                            y_score.append(pred.score)

                if have_gt and have_pred:
                    ap[di, li, oi] = _ap_from_curve(
                        np.asarray(y_true, float),
                        np.asarray(y_score, float),
                        hard_fns,
                    )
                elif have_gt:
                    ap[di, li, oi] = 0.0
                else:
                    ap[di, li, oi] = float("nan")
    return ap


def compute_averages(ap, class_names):
    d = int(np.argmin(MIN_REGION_SIZES))
    o50 = np.isclose(OVERLAPS, 0.5)
    o75 = np.isclose(OVERLAPS, 0.75)
    avg = {
        "allAp": float(np.nanmean(ap[d])),
        "allAp50%": float(np.nanmean(ap[d][:, o50])),
        "allAp75%": float(np.nanmean(ap[d][:, o75])),
        "classes": {},
    }
    for li, name in enumerate(class_names):
        avg["classes"][name] = {
            "ap": float(np.average(ap[d, li])),
            "ap50%": float(np.average(ap[d, li, o50])),
            "ap75%": float(np.average(ap[d, li, o75])),
        }
    return avg


def _format_results(avg, class_names):
    lines = ["{:<15}{:>10}{:>10}{:>10}".format("what", "AP", "AP_50%", "AP_75%")]
    for name in class_names:
        c = avg["classes"][name]
        lines.append(
            "{:<15}{:>10.3f}{:>10.3f}{:>10.3f}".format(
                name, c["ap"], c["ap50%"], c["ap75%"]
            )
        )
    lines.append(
        "{:<15}{:>10.3f}{:>10.3f}{:>10.3f}".format(
            "average", avg["allAp"], avg["allAp50%"], avg["allAp75%"]
        )
    )
    return "\n".join(lines)


def do_cityscapes_evaluation(dataset, predictions, box_only, output_folder,
                             iou_types, expected_results,
                             expected_results_sigma_tol, **_):
    logger = logging.getLogger("maskrcnn_tpu_torch.inference")
    class_names = list(dataset.CLASSES)
    matches = match_gts_with_preds(dataset, predictions)

    results = {}
    for iou_type, metric, fname in (
        ("bbox", "box", "boxResult.json"),
        ("segm", "mask", "maskResult.json"),
    ):
        if iou_type not in iou_types:
            continue
        ap = evaluate_matches(matches, class_names, metric)
        avg = compute_averages(ap, class_names)
        results[iou_type] = avg
        logger.info("Cityscapes %s results:\n%s", iou_type,
                    _format_results(avg, class_names))
        if output_folder:
            out = os.path.join(output_folder, "evaluationResults")
            os.makedirs(out, exist_ok=True)
            with open(os.path.join(out, fname), "w") as f:
                json.dump(
                    {
                        "averages": avg,
                        "overlaps": OVERLAPS.tolist(),
                        "minRegionSizes": list(MIN_REGION_SIZES),
                        "instLabels": class_names,
                        "resultApMatrix": ap.tolist(),
                    },
                    f,
                    indent=2,
                )

    # TEST.EXPECTED_RESULTS acceptance gate — the reference's cityscapes
    # evaluator ignores these, but this framework builds its acceptance
    # workflow (tools/eval_zoo.py) on the gate, so it must bind here too.
    # Expected rows use (task, metric) = ("bbox"/"segm", "allAp"/"allAp50%").
    if expected_results:
        errors = []
        for task, metric, mean, std in expected_results:
            if task not in results:
                continue
            actual = results[task].get(metric)
            lo = mean - expected_results_sigma_tol * std
            hi = mean + expected_results_sigma_tol * std
            ok = actual is not None and lo < actual < hi
            msg = "{} > {} sanity check {}: {} vs [{:.4f}, {:.4f}]".format(
                task, metric, "passed" if ok else "FAILED", actual, lo, hi
            )
            (logger.info if ok else logger.error)(msg)
            if not ok:
                errors.append(msg)
        if errors:
            raise AssertionError("\n".join(errors))
    return results
