"""Evaluation dispatch by dataset type.

Port of maskrcnn_tpu/data/evaluation/__init__.py (after the reference
maskrcnn_benchmark/data/datasets/evaluation/__init__.py:7-29): COCO
datasets go to the COCO evaluator. The VOC and Cityscapes evaluators wait
with their datasets (ROADMAP.md Queue 1 item 4).
"""

from ..datasets import COCODataset
from .coco_eval import do_coco_evaluation


def evaluate(dataset, predictions, output_folder, iou_types=("bbox",), box_only=False,
             expected_results=(), expected_results_sigma_tol=4):
    if isinstance(dataset, COCODataset):
        return do_coco_evaluation(
            dataset=dataset, predictions=predictions, box_only=box_only,
            output_folder=output_folder, iou_types=list(iou_types),
            expected_results=expected_results,
            expected_results_sigma_tol=expected_results_sigma_tol,
        )
    raise NotImplementedError(
        "evaluation of {} is not ported yet (VOC and Cityscapes: ROADMAP.md Queue 1 item 4)"
        .format(dataset.__class__.__name__))
