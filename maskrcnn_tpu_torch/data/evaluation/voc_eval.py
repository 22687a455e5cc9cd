"""Pascal VOC detection mAP (VOC07 11-point / VOC-style continuous AP).

Port copy of maskrcnn_tpu/data/evaluation/voc_eval.py (numpy only).
Covers the same protocol as the reference's VOC evaluation
(maskrcnn_benchmark/data/datasets/evaluation/voc/voc_eval.py) but is built
around a different pipeline: detections are bucketed per class across the
whole dataset up front, ranked once by score globally, and matched in that
single ranked sweep against per-image ground-truth tables. The devkit rules
are unchanged (they are the protocol):

  * a detection matches the ground-truth box of its image/class with the
    highest IoU, if that IoU clears `iou_thresh`
  * each non-difficult ground-truth box can validate only one detection
    (the highest-scored one); later matches count as false positives
  * detections whose best match is a `difficult` box are ignored entirely
  * recall denominators count non-difficult boxes only
  * boxes use the legacy +1 pixel convention (BoxList / devkit area math)
"""

import logging
import os

import numpy as np

_EPS = np.finfo(np.float64).eps


def _pairwise_iou(one_box, many_boxes):
    """IoU of one [4] box against [N, 4] boxes, +1 pixel convention."""
    ix = np.minimum(one_box[2], many_boxes[:, 2]) - np.maximum(
        one_box[0], many_boxes[:, 0]
    ) + 1
    iy = np.minimum(one_box[3], many_boxes[:, 3]) - np.maximum(
        one_box[1], many_boxes[:, 1]
    ) + 1
    inter = np.clip(ix, 0, None) * np.clip(iy, 0, None)
    area = lambda b: (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    union = area(one_box) + area(many_boxes) - inter
    return inter / np.maximum(union, _EPS)


def _rank_sweep(det_img, det_box, gt_tables, iou_thresh):
    """Walk score-ranked detections of one class; returns outcome per
    detection: +1 true positive, 0 false positive, -1 ignored (difficult).

    gt_tables: {image_id: [boxes [N,4], difficult [N] bool, taken [N] bool]}
    (taken is mutated in place as boxes are claimed).
    """
    outcome = np.zeros(len(det_img), np.int8)
    for rank in range(len(det_img)):
        table = gt_tables.get(int(det_img[rank]))
        if table is None or len(table[0]) == 0:
            continue  # stays 0: false positive
        boxes, difficult, taken = table
        overlaps = _pairwise_iou(det_box[rank], boxes)
        best = int(np.argmax(overlaps))
        if overlaps[best] < iou_thresh:
            continue
        if difficult[best]:
            outcome[rank] = -1
        elif not taken[best]:
            outcome[rank] = 1
            taken[best] = True
        # else: duplicate of an already-claimed box -> false positive
    return outcome


def _precision_recall_curve(outcome, num_gt):
    """Cumulative precision/recall along the ranked axis, ignoring -1 rows."""
    counted = outcome >= 0
    tp = np.cumsum((outcome == 1) & counted)
    seen = np.cumsum(counted)
    precision = tp / np.maximum(seen, _EPS)
    recall = tp / num_gt if num_gt > 0 else None
    return precision, recall


def _area_under_pr(precision, recall, eleven_point):
    """AP from a PR curve. eleven_point: VOC2007 sampling at r=0,.1,..,1;
    otherwise the exact area under the interpolated-precision envelope."""
    if recall is None:
        return np.nan
    # interpolated precision: best precision at any recall >= r
    envelope = np.maximum.accumulate(precision[::-1])[::-1]
    if eleven_point:
        total = 0.0
        for r in np.linspace(0.0, 1.0, 11):
            at = np.searchsorted(recall, r, side="left")
            total += envelope[at] if at < len(envelope) else 0.0
        return total / 11.0
    # exact area: pad the curve with (r=0) and a terminal zero-precision
    # point, then sum envelope * recall-step at each recall increase
    env = np.concatenate([[envelope[0] if len(envelope) else 0.0], envelope, [0.0]])
    rec = np.concatenate([[0.0], recall, [1.0]])
    env = np.maximum.accumulate(env[::-1])[::-1]
    steps = rec[1:] - rec[:-1]
    return float(np.sum(steps * env[1:]))


def eval_detection_voc(pred_boxlists, gt_boxlists, iou_thresh=0.5,
                       use_07_metric=False):
    """Dataset-level VOC AP. pred/gt_boxlists: parallel per-image BoxLists;
    predictions carry 'labels'/'scores', ground truth 'labels'/'difficult'.
    Returns {"ap": [num_classes] array (nan where class absent), "map"}."""
    assert len(gt_boxlists) == len(pred_boxlists)

    # bucket the whole dataset by class
    det_by_class = {}  # c -> [scores], [image ids], [boxes]
    gt_by_class = {}  # c -> {image: [boxes, difficult, taken]}
    gt_counts = {}  # c -> non-difficult box count
    for img, (pred, gt) in enumerate(zip(pred_boxlists, gt_boxlists)):
        p_boxes = np.asarray(pred.bbox, np.float64)
        p_labels = np.asarray(pred.get_field("labels")).astype(int)
        p_scores = np.asarray(pred.get_field("scores"), np.float64)
        for c in np.unique(p_labels):
            rows = p_labels == c
            bucket = det_by_class.setdefault(int(c), ([], [], []))
            bucket[0].append(p_scores[rows])
            bucket[1].append(np.full(rows.sum(), img, np.int64))
            bucket[2].append(p_boxes[rows])
        g_boxes = np.asarray(gt.bbox, np.float64)
        g_labels = np.asarray(gt.get_field("labels")).astype(int)
        g_diff = np.asarray(gt.get_field("difficult")).astype(bool)
        for c in np.unique(g_labels):
            rows = g_labels == c
            gt_by_class.setdefault(int(c), {})[img] = [
                g_boxes[rows], g_diff[rows], np.zeros(rows.sum(), bool)
            ]
            gt_counts[int(c)] = gt_counts.get(int(c), 0) + int(
                (~g_diff[rows]).sum()
            )

    classes = sorted(set(det_by_class) | set(gt_by_class))
    num_classes = (max(classes) + 1) if classes else 0
    ap = np.full(num_classes, np.nan)
    for c in classes:
        num_gt = gt_counts.get(c, 0)
        if c not in det_by_class:
            # no detections: AP is 0 when the class has ground truth
            ap[c] = 0.0 if num_gt > 0 else np.nan
            continue
        scores = np.concatenate(det_by_class[c][0])
        imgs = np.concatenate(det_by_class[c][1])
        boxes = np.concatenate(det_by_class[c][2])
        order = np.argsort(-scores, kind="stable")
        outcome = _rank_sweep(
            imgs[order], boxes[order], gt_by_class.get(c, {}), iou_thresh
        )
        precision, recall = _precision_recall_curve(outcome, num_gt)
        ap[c] = _area_under_pr(precision, recall, use_07_metric)
    return {"ap": ap, "map": np.nanmean(ap) if len(ap) else np.nan}


def do_voc_evaluation(dataset, predictions, output_folder, logger=None):
    """Engine-facing entry point: resize predictions to original image
    coordinates, evaluate at IoU 0.5 with the VOC07 metric, log + save."""
    logger = logger or logging.getLogger("maskrcnn_tpu_torch.inference")
    pred_boxlists, gt_boxlists = [], []
    for image_id, prediction in enumerate(predictions):
        info = dataset.get_img_info(image_id)
        pred_boxlists.append(prediction.resize((info["width"], info["height"])))
        gt_boxlists.append(dataset.get_groundtruth(image_id))
    result = eval_detection_voc(
        pred_boxlists, gt_boxlists, iou_thresh=0.5, use_07_metric=True
    )
    lines = ["mAP: {:.4f}".format(result["map"])]
    for c, class_ap in enumerate(result["ap"]):
        if c == 0:
            continue
        lines.append(
            "{:<16}: {:.4f}".format(dataset.map_class_id_to_class_name(c), class_ap)
        )
    result_str = "\n".join(lines) + "\n"
    logger.info(result_str)
    if output_folder:
        with open(os.path.join(output_folder, "result.txt"), "w") as f:
            f.write(result_str)
    return result
