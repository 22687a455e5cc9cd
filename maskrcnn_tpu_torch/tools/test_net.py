"""Evaluation entry point.

    python -m maskrcnn_tpu_torch.tools.test_net [--config-file FILE] [--ckpt PATH] [KEY VALUE ...]
    python -m torch.distributed.run --nproc_per_node N -m maskrcnn_tpu_torch.tools.test_net ...

The surface of the JAX package's tools/test_net.py (after the reference
tools/test_net.py): a YAML config file, ``--ckpt`` and KEY VALUE overrides
of the configuration. The device is MODEL.DEVICE ("cuda" by default, "cpu"
on request). The weights come from OUTPUT_DIR's last_checkpoint when there
is one, else from --ckpt, else from MODEL.WEIGHT: a .pth of this package or
a .npz of the JAX package. Every dataset of DATASETS.TEST is evaluated (bbox,
and segm for mask models), its predictions written to
OUTPUT_DIR/inference/<name>/predictions.pkl when OUTPUT_DIR is set. With
TEST.BBOX_AUG.ENABLED the detections are test-time augmented
(engine/bbox_aug.py), which answers bbox alone: a mask or keypoint
model's evaluation then raises ValueError before its first pass.

Under a launcher each process takes one card and its data coordinate's
shard of every test dataset (TEST.IMS_PER_BATCH stays the global batch);
with a "model" axis in TPU.MESH_AXES / MESH_SHAPE the loaded weights are
sharded over it as in train_net (the JAX package's test_net reads neither
key); rank 0 gathers, evaluates and returns the results, the other ranks
return None (train_net.py has the group's set-up).
"""

import argparse
import os

import torch

from ..config import cfg as default_cfg
from ..data.build import make_data_loader
from ..engine.inference import inference
from ..models.detector import build_detection_model
from ..parallel import init_distributed, shard_model
from ..utils import comm
from ..utils.checkpoint import DetectronCheckpointer
from ..utils.collect_env import collect_env_info
from ..utils.logger import setup_logger
from ..utils.miscellaneous import mkdir


def box_only(cfg):
    """Whether the evaluation is of proposals (box recall) rather than of
    detections: RPN-only models, but not RetinaNet, whose P5 configs set
    RPN_ONLY too (the reference's test_net)."""
    return cfg.MODEL.RPN_ONLY and not cfg.MODEL.RETINANET_ON


def run_test(cfg, model):
    """Evaluate `model` on every dataset of DATASETS.TEST, each process of a
    group on its shard; returns the list of inference's results, one per
    dataset (None on the ranks other than 0)."""
    iou_types = ("bbox",)
    if cfg.MODEL.MASK_ON:
        iou_types = iou_types + ("segm",)
    if cfg.MODEL.KEYPOINT_ON:
        iou_types = iou_types + ("keypoints",)
    output_folders = [None] * len(cfg.DATASETS.TEST)
    if cfg.OUTPUT_DIR:
        for idx, dataset_name in enumerate(cfg.DATASETS.TEST):
            output_folders[idx] = os.path.join(cfg.OUTPUT_DIR, "inference", dataset_name)
            mkdir(output_folders[idx])
    results = []
    for output_folder, dataset_name, data_loader in zip(
            output_folders, cfg.DATASETS.TEST,
            make_data_loader(cfg, is_train=False, is_distributed=comm.get_world_size() > 1)):
        results.append(inference(
            model, data_loader, dataset_name=dataset_name, iou_types=iou_types,
            box_only=box_only(cfg), output_folder=output_folder,
            expected_results=cfg.TEST.EXPECTED_RESULTS,
            expected_results_sigma_tol=cfg.TEST.EXPECTED_RESULTS_SIGMA_TOL, bbox_aug_cfg=cfg))
        comm.synchronize()
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description="Mask R-CNN inference (PyTorch/CUDA)")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--ckpt", default=None,
                        help="checkpoint file; defaults to last_checkpoint, then MODEL.WEIGHT")
    parser.add_argument("--local_rank", "--local-rank", dest="local_rank", type=int, default=0)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = default_cfg.clone()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()

    device = init_distributed(cfg)
    logger = setup_logger("maskrcnn_tpu_torch", "", comm.get_rank())
    logger.info("Using {} processes".format(comm.get_world_size()))
    logger.info("Using {} (torch {}, CUDA {})".format(
        torch.cuda.get_device_name(device) if device.type == "cuda" else "the CPU",
        torch.__version__, torch.version.cuda))
    logger.info(cfg)
    logger.info("Collecting env info:\n" + collect_env_info())

    model = build_detection_model(cfg, device=device)
    checkpointer = DetectronCheckpointer(cfg, model, save_dir=cfg.OUTPUT_DIR, logger=logger)
    checkpointer.load(cfg.MODEL.WEIGHT if args.ckpt is None else args.ckpt)
    shard_model(model)
    results = run_test(cfg, model)
    return results if comm.is_main_process() else None


if __name__ == "__main__":
    main()
