"""Evaluation loop: run the model over a test loader, gather, evaluate.

Port of maskrcnn_tpu/engine/inference.py (after the reference
maskrcnn_benchmark/engine/inference.py:17-120). The model's outputs are
padded fixed-shape dicts on the card; each batch is copied there with
``non_blocking=True`` (the loader pins it) and its detections come back to
the host in one wait, then become BoxLists resized to the original images.
Keypoint fields (ROADMAP.md Queue 1 item 8) are not ported yet and raise;
so does a test loader with test-time augmentation (item 14,
data/build.py).

In a process group each rank runs its shard of the dataset (the
distributed test loader's), ``comm.all_gather`` merges the shards and rank
0 keeps one prediction per dataset index (the sampler pads the last shard
with repeated images), writes them and evaluates; the other ranks return
None.
"""

import logging
import os
import pickle

import numpy as np
import torch

from ..data.evaluation import evaluate
from ..structures import BoxList
from ..utils import comm
from ..utils.timer import Timer
from .train_step import make_eval_step


def detections_to_boxlists(det, image_sizes):
    """Padded detection dict (host arrays or CPU tensors: boxes [B, D, 4],
    scores, labels and valid [B, D], masks [B, D, M, M]) -> one BoxList per
    image of its valid detections, on the resized image (w, h) of
    image_sizes [B, 2] (h, w)."""
    if "keypoints" in det or "kp_heatmaps" in det:
        raise NotImplementedError("keypoint detections wait for the keypoint family "
                                  "(ROADMAP.md Queue 1 item 8)")
    boxes = np.asarray(det["boxes"])
    scores = np.asarray(det["scores"])
    labels = np.asarray(det["labels"])
    valid = np.asarray(det["valid"])
    masks = np.asarray(det["masks"]) if "masks" in det else None
    image_sizes = np.asarray(image_sizes)
    out = []
    for i in range(boxes.shape[0]):
        v = valid[i]
        h, w = int(image_sizes[i][0]), int(image_sizes[i][1])
        bl = BoxList(boxes[i][v], (w, h), mode="xyxy")
        bl.add_field("scores", scores[i][v])
        bl.add_field("labels", labels[i][v])
        if masks is not None:
            bl.add_field("mask", masks[i][v])
        out.append(bl)
    return out


def _to_host(det):
    """The detection dict as CPU tensors, with a single wait for the card:
    every copy is queued first (into pinned memory), then the stream is
    synchronized once."""
    out = {k: v.to("cpu", non_blocking=True) for k, v in det.items()}
    if det["boxes"].is_cuda:
        torch.cuda.current_stream(det["boxes"].device).synchronize()
    return out


def compute_on_dataset(model, data_loader, timer=None):
    """{dataset index: BoxList of its detections on the original image}
    for every image of the loader, the model on its own device. `timer`
    covers each batch from its copy to the card to its detections on the
    host."""
    device = next(model.parameters()).device
    eval_step = make_eval_step(model)
    results = {}
    logger = logging.getLogger("maskrcnn_tpu_torch.inference")
    dataset = data_loader.dataset
    for it, batch in enumerate(data_loader):
        if timer:
            timer.tic()
        det = _to_host(eval_step({k: batch[k].to(device, non_blocking=True)
                                  for k in ("images", "image_sizes")}))
        if timer:
            timer.toc()
        boxlists = detections_to_boxlists(det, batch["image_sizes"])
        for i, idx in enumerate(batch["indices"].tolist()):
            info = dataset.get_img_info(idx)
            results[idx] = boxlists[i].resize((info["width"], info["height"]))
        if it % 50 == 0:
            logger.info("processed batch {} ({} images)".format(it, len(results)))
    return results


def inference(model, data_loader, dataset_name, iou_types=("bbox",), box_only=False,
              output_folder=None, expected_results=(), expected_results_sigma_tol=4):
    """Detections for every image of `data_loader`, written to
    output_folder/predictions.pkl (a pickled list of BoxLists by dataset
    index) when an output folder is given, and evaluated; returns what
    ``data.evaluation.evaluate`` returns, (COCOResults, {}) for COCO; None
    on the ranks other than 0 of a process group, which run their shards."""
    logger = logging.getLogger("maskrcnn_tpu_torch.inference")
    dataset = data_loader.dataset
    logger.info("Start evaluation on {} dataset({} images).".format(dataset_name, len(dataset)))
    total_timer = Timer()
    inference_timer = Timer()
    total_timer.tic()
    predictions = compute_on_dataset(model, data_loader, inference_timer)
    comm.synchronize()
    total_time = total_timer.toc()
    logger.info("Total run time: {:.3f} s ({:.4f} s / img per device)".format(
        total_time, total_time / max(len(predictions), 1)))
    logger.info("Model inference time: {:.4f} s / img".format(
        inference_timer.total_time / max(len(predictions), 1)))

    predictions = {k: v for p in comm.all_gather(predictions) for k, v in p.items()}
    if not comm.is_main_process():
        return None
    image_ids = sorted(predictions.keys())
    if len(image_ids) != len(dataset):
        logger.warning("Number of images that were gathered from multiple processes is not a "
                       "contiguous set. Some images might be missing from the evaluation")
    predictions = [predictions[i] for i in image_ids]

    if output_folder:
        os.makedirs(output_folder, exist_ok=True)
        with open(os.path.join(output_folder, "predictions.pkl"), "wb") as f:
            pickle.dump(predictions, f)

    return evaluate(dataset=dataset, predictions=predictions, output_folder=output_folder,
                    iou_types=iou_types, box_only=box_only, expected_results=expected_results,
                    expected_results_sigma_tol=expected_results_sigma_tol)
