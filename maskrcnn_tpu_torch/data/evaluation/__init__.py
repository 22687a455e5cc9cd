"""Evaluation dispatch by dataset type.

Port copy of maskrcnn_tpu/data/evaluation/__init__.py (after the reference
maskrcnn_benchmark/data/datasets/evaluation/__init__.py:7-29): a
concatenation is evaluated as its first dataset; COCO, Pascal VOC, and any
other AbstractDataset (Cityscapes) go to their evaluators.
"""

from ..datasets import (
    AbstractDataset,
    COCODataset,
    ConcatDataset,
    PascalVOCDataset,
)
from .cityscapes_eval import do_cityscapes_evaluation
from .coco_eval import do_coco_evaluation
from .voc_eval import do_voc_evaluation


def evaluate(dataset, predictions, output_folder, iou_types=("bbox",),
             box_only=False, expected_results=(), expected_results_sigma_tol=4,
             **kwargs):
    if isinstance(dataset, ConcatDataset):
        dataset = dataset.datasets[0]
    if isinstance(dataset, COCODataset):
        return do_coco_evaluation(
            dataset=dataset,
            predictions=predictions,
            box_only=box_only,
            output_folder=output_folder,
            iou_types=list(iou_types),
            expected_results=expected_results,
            expected_results_sigma_tol=expected_results_sigma_tol,
        )
    if isinstance(dataset, PascalVOCDataset):
        return do_voc_evaluation(
            dataset=dataset, predictions=predictions, output_folder=output_folder
        )
    if isinstance(dataset, AbstractDataset):
        # the reference routes every AbstractDataset (CityScapesDataset et
        # al.) to the cityscapes instance-level evaluator (evaluation/
        # __init__.py:25-26)
        return do_cityscapes_evaluation(
            dataset=dataset,
            predictions=predictions,
            box_only=box_only,
            output_folder=output_folder,
            iou_types=list(iou_types),
            expected_results=expected_results,
            expected_results_sigma_tol=expected_results_sigma_tol,
        )
    raise NotImplementedError(
        "Unsupported dataset type {}.".format(dataset.__class__.__name__)
    )
