"""COCO evaluation glue: BoxList predictions -> COCO-format -> metrics.

Port of maskrcnn_tpu/data/evaluation/coco_eval.py (after the reference
maskrcnn_benchmark/data/datasets/evaluation/coco/coco_eval.py:
prepare_for_coco_{detection:70, segmentation:104, keypoint:143},
evaluate_box_proposals:189,
COCOResults:326, check_expected_results:377). The COCOeval engine is
data/evaluation/cocoeval.py; segmentation results are pasted and encoded by
the native ``maskops.paste_encode_mask``, bit-equal to the JAX package's;
keypoint results are COCO triplets (x, y, 1) of the detections' joints.
"""

import logging
from collections import OrderedDict

import numpy as np

from ...structures import BoxList
from ...structures.boxlist_ops import boxlist_iou
from ...utils import maskops
from .cocoeval import COCOEvaluator


def prepare_for_coco_detection(predictions, dataset):
    results = {}
    for image_id, prediction in enumerate(predictions):
        original_id = dataset.id_to_img_map[image_id]
        if len(prediction) == 0:
            results[original_id] = []
            continue
        prediction = prediction.convert("xywh")
        boxes = prediction.bbox.tolist()
        scores = prediction.get_field("scores").tolist()
        labels = prediction.get_field("labels").tolist()
        mapped = [dataset.contiguous_category_id_to_json_id[int(i)] for i in labels]
        results[original_id] = [
            {"image_id": original_id, "category_id": mapped[k], "bbox": box, "score": scores[k]}
            for k, box in enumerate(boxes)
        ]
    return results


def prepare_for_coco_segmentation(predictions, dataset):
    results = {}
    for image_id, prediction in enumerate(predictions):
        original_id = dataset.id_to_img_map[image_id]
        if len(prediction) == 0:
            results[original_id] = []
            continue
        info = dataset.get_img_info(image_id)
        w, h = info["width"], info["height"]
        prediction = prediction.resize((w, h)).convert("xyxy")
        masks = np.asarray(prediction.get_field("mask"))
        boxes = np.asarray(prediction.bbox)
        scores = prediction.get_field("scores").tolist()
        labels = prediction.get_field("labels").tolist()
        rles = [maskops.paste_encode_mask(masks[k], boxes[k], h, w) for k in range(len(boxes))]
        mapped = [dataset.contiguous_category_id_to_json_id[int(i)] for i in labels]
        xywh = prediction.convert("xywh").bbox
        results[original_id] = [
            {"image_id": original_id, "category_id": mapped[k], "segmentation": rle,
             "bbox": xywh[k].tolist(), "score": scores[k]}
            for k, rle in enumerate(rles)
        ]
    return results


def prepare_for_coco_keypoint(predictions, dataset):
    results = {}
    for image_id, prediction in enumerate(predictions):
        original_id = dataset.id_to_img_map[image_id]
        if len(prediction) == 0:
            results[original_id] = []
            continue
        prediction = prediction.convert("xywh")
        boxes = prediction.bbox.tolist()
        scores = prediction.get_field("scores").tolist()
        labels = prediction.get_field("labels").tolist()
        kps = np.asarray(prediction.get_field("keypoints"))
        # [N, K, 4] (x, y, 1, logit) -> COCO triplets (x, y, 1)
        triplets = np.concatenate([kps[..., :2], np.ones((*kps.shape[:2], 1))],
                                  axis=-1).reshape(len(boxes), -1)
        mapped = [dataset.contiguous_category_id_to_json_id[int(i)] for i in labels]
        results[original_id] = [
            {"image_id": original_id, "category_id": mapped[k], "keypoints": triplets[k].tolist(),
             "bbox": boxes[k], "score": scores[k]}
            for k in range(len(boxes))
        ]
    return results


def evaluate_box_proposals(predictions, dataset, thresholds=None, area="all", limit=None):
    """Average recall of raw proposals (RPN-only path; coco_eval.py:189)."""
    areas = {"all": 0, "small": 1, "medium": 2, "large": 3,
             "96-128": 4, "128-256": 5, "256-512": 6, "512-inf": 7}
    area_ranges = [
        [0 ** 2, 1e5 ** 2], [0 ** 2, 32 ** 2], [32 ** 2, 96 ** 2],
        [96 ** 2, 1e5 ** 2], [96 ** 2, 128 ** 2], [128 ** 2, 256 ** 2],
        [256 ** 2, 512 ** 2], [512 ** 2, 1e5 ** 2],
    ]
    if area not in areas:
        raise ValueError("unknown area range {}".format(area))
    area_range = area_ranges[areas[area]]
    gt_overlaps = []
    num_pos = 0
    for image_id, prediction in enumerate(predictions):
        original_id = dataset.id_to_img_map[image_id]
        info = dataset.get_img_info(image_id)
        prediction = prediction.resize((info["width"], info["height"]))
        if prediction.has_field("objectness"):
            inds = np.argsort(-np.asarray(prediction.get_field("objectness")))
        else:
            inds = np.argsort(-np.asarray(prediction.get_field("scores")))
        prediction = prediction[inds]

        anns = [a for a in dataset.anns_by_img[original_id] if a.get("iscrowd", 0) == 0]
        gt_boxes = np.asarray([a["bbox"] for a in anns], np.float32).reshape(-1, 4)
        gt_bl = BoxList(gt_boxes, (info["width"], info["height"]), "xywh").convert("xyxy")
        gt_areas = np.asarray([a["bbox"][2] * a["bbox"][3] for a in anns])
        valid = (gt_areas >= area_range[0]) & (gt_areas < area_range[1])
        gt_bl = gt_bl[valid]
        num_pos += len(gt_bl)
        if len(gt_bl) == 0 or len(prediction) == 0:
            continue
        if limit is not None and len(prediction) > limit:
            prediction = prediction[np.arange(limit)]
        overlaps = boxlist_iou(prediction, gt_bl)
        _gt_overlaps = np.zeros(len(gt_bl))
        for j in range(min(len(prediction), len(gt_bl))):
            max_overlaps = overlaps.max(axis=0)
            argmax_overlaps = overlaps.argmax(axis=0)
            gt_ind = max_overlaps.argmax()
            box_ind = argmax_overlaps[gt_ind]
            _gt_overlaps[j] = overlaps[box_ind, gt_ind]
            overlaps[box_ind, :] = -1
            overlaps[:, gt_ind] = -1
        gt_overlaps.append(_gt_overlaps)

    gt_overlaps = np.concatenate(gt_overlaps) if gt_overlaps else np.zeros(0)
    gt_overlaps = np.sort(gt_overlaps)
    if thresholds is None:
        thresholds = np.arange(0.5, 0.95 + 1e-5, 0.05)
    recalls = np.zeros_like(thresholds)
    for i, t in enumerate(thresholds):
        recalls[i] = (gt_overlaps >= t).sum() / float(num_pos) if num_pos else 0.0
    return {"ar": recalls.mean(), "recalls": recalls, "thresholds": thresholds,
            "gt_overlaps": gt_overlaps, "num_pos": num_pos}


class COCOResults:
    METRICS = {
        "bbox": ["AP", "AP50", "AP75", "APs", "APm", "APl"],
        "segm": ["AP", "AP50", "AP75", "APs", "APm", "APl"],
        "box_proposal": [
            "AR@100", "ARs@100", "ARm@100", "ARl@100", "AR@1000",
            "ARs@1000", "ARm@1000", "ARl@1000",
        ],
        "keypoints": ["AP", "AP50", "AP75", "APm", "APl"],
    }

    def __init__(self, *iou_types):
        unknown = [t for t in iou_types if t not in COCOResults.METRICS]
        if unknown:
            raise ValueError("unknown iou types {}".format(unknown))
        self.results = OrderedDict(
            (t, OrderedDict((m, -1.0) for m in COCOResults.METRICS[t])) for t in iou_types)

    def update(self, iou_type, stats):
        for metric in self.results[iou_type]:
            if metric in stats:
                self.results[iou_type][metric] = stats[metric]

    def __repr__(self):
        lines = []
        for task, metrics in self.results.items():
            names = ", ".join(metrics.keys())
            vals = ", ".join("{:.4f}".format(v) for v in metrics.values())
            lines.append("Task: {}\n{}\n{}".format(task, names, vals))
        return "\n".join(lines)


def check_expected_results(results, expected_results, sigma_tol):
    """Regression gate (coco_eval.py:377-396): each (task, metric, mean,
    std) of TEST.EXPECTED_RESULTS must lie strictly within sigma_tol std of
    its mean; raises AssertionError naming every one that does not."""
    logger = logging.getLogger("maskrcnn_tpu_torch.inference")
    errors = []
    for task, metric, mean, std in expected_results:
        actual_val = results.results[task][metric]
        lo, hi = mean - sigma_tol * std, mean + sigma_tol * std
        ok = lo < actual_val < hi
        msg = "{} > {} sanity check {}: {:.4f} vs [{:.4f}, {:.4f}]".format(
            task, metric, "passed" if ok else "FAILED", actual_val, lo, hi)
        if ok:
            logger.info(msg)
        else:
            logger.error(msg)
            errors.append(msg)
    if errors:
        raise AssertionError("\n".join(errors))


def do_coco_evaluation(dataset, predictions, box_only, output_folder, iou_types,
                       expected_results, expected_results_sigma_tol):
    logger = logging.getLogger("maskrcnn_tpu_torch.inference")

    if box_only:
        logger.info("Evaluating bbox proposals")
        areas = {"all": "", "small": "s", "medium": "m", "large": "l"}
        res = COCOResults("box_proposal")
        for limit in [100, 1000]:
            for area, suffix in areas.items():
                stats = evaluate_box_proposals(predictions, dataset, area=area, limit=limit)
                key = "AR{}@{:d}".format(suffix, limit)
                res.results["box_proposal"][key] = stats["ar"].item()
        logger.info(res)
        check_expected_results(res, expected_results, expected_results_sigma_tol)
        return res, {}

    preparers = {
        "bbox": prepare_for_coco_detection,
        "segm": prepare_for_coco_segmentation,
        "keypoints": prepare_for_coco_keypoint,
    }
    results = COCOResults(*iou_types)
    for iou_type in iou_types:
        logger.info("Preparing results for COCO format: {}".format(iou_type))
        coco_results = preparers[iou_type](predictions, dataset)
        logger.info("Evaluating predictions: {}".format(iou_type))
        evaluator = COCOEvaluator(dataset, iou_type=iou_type)
        stats = evaluator.evaluate(coco_results)
        results.update(iou_type, stats)
        logger.info("{}: {}".format(iou_type, stats))
    logger.info(results)
    check_expected_results(results, expected_results, expected_results_sigma_tol)
    return results, {}
