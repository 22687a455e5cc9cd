"""Training entry point.

    python -m maskrcnn_tpu_torch.tools.train_net [--config-file FILE] [--skip-test] [KEY VALUE ...]
    python -m torch.distributed.run --nproc_per_node N -m maskrcnn_tpu_torch.tools.train_net ...

The surface of the JAX package's tools/train_net.py (after the reference
tools/train_net.py): a YAML config file, ``--skip-test`` and KEY VALUE
overrides of the configuration. The device is MODEL.DEVICE ("cuda" by
default, "cpu" on request). The model trains from MODEL.WEIGHT (a .pth of
this package or a .npz of the JAX package; "" for the seeded init) or
resumes from OUTPUT_DIR's last_checkpoint. With SOLVER.TEST_PERIOD > 0 the
datasets of DATASETS.TEST are evaluated (bbox) every TEST_PERIOD
iterations; after training, unless --skip-test, they are evaluated as
test_net does.

Under a launcher (``torchrun``: WORLD_SIZE and the rest in the environment)
each process takes one card (cuda:LOCAL_RANK) and an NCCL group is made
(gloo with MODEL.DEVICE cpu); a caller that made the default group first
keeps it. The processes lay out the mesh of TPU.MESH_AXES / MESH_SHAPE
(parallel/mesh.py), as the JAX package's train_net does over its devices:
with a "model" axis above 1, say ("data", "model") / (-1, 2), the weights'
output channels are sharded over it after loading (shard_model) and each
layer gathers its weight at use. SOLVER.IMS_PER_BATCH and
TEST.IMS_PER_BATCH stay the global batch, each data coordinate loading its
share (they must divide by the data axis); the step is the global-batch
step of the JAX package's mesh (engine/train_step.py). Rank 0 logs, writes
the checkpoints (at the full layout) and evaluates the gathered
predictions; validation and the final test run the sharded model.
``--local_rank`` / ``--local-rank`` (torch.distributed.launch) are
accepted; the device follows LOCAL_RANK.
"""

import argparse
import os

import torch

from ..config import cfg as default_cfg
from ..data.build import make_data_loader
from ..engine.inference import inference
from ..engine.trainer import do_train
from ..models.detector import build_detection_model
from ..parallel import broadcast_parameters, init_distributed, shard_model
from ..solver import make_lr_scheduler, make_optimizer
from ..utils import comm
from ..utils.checkpoint import DetectronCheckpointer
from ..utils.collect_env import collect_env_info
from ..utils.logger import setup_logger
from ..utils.miscellaneous import mkdir, save_config, save_labels
from .test_net import box_only, run_test


def train(cfg, output_dir, device):
    """Build, load or resume, and train on `device`, validating every
    SOLVER.TEST_PERIOD iterations; returns (model, meters). In a process
    group (init_distributed) every rank starts from rank 0's parameters,
    then takes its blocks of them under a "model" axis: the optimizer is
    built, the checkpoint (a resumed momentum too) loaded and the
    parameters broadcast at the full layout before shard_model."""
    distributed = comm.get_world_size() > 1
    model = build_detection_model(cfg, device=device)
    optimizer = make_optimizer(cfg, model)
    scheduler = make_lr_scheduler(cfg, optimizer)
    arguments = {"iteration": 0}
    checkpointer = DetectronCheckpointer(
        cfg, model, optimizer, scheduler, output_dir,
        logger=setup_logger("maskrcnn_tpu_torch.checkpointer", None, comm.get_rank()))
    arguments.update(checkpointer.load(cfg.MODEL.WEIGHT))
    broadcast_parameters(model)
    shard_model(model, optimizer)
    data_loader = make_data_loader(cfg, is_train=True, is_distributed=distributed,
                                   start_iter=arguments["iteration"])
    if output_dir:
        save_labels([data_loader.dataset], output_dir)
    test_period = cfg.SOLVER.TEST_PERIOD
    run_validation = None
    if test_period > 0 and cfg.DATASETS.TEST:
        val_loaders = make_data_loader(cfg, is_train=False, is_distributed=distributed)

        def run_validation(val_model, iteration):
            for name, loader in zip(cfg.DATASETS.TEST, val_loaders):
                inference(val_model, loader, dataset_name=name, iou_types=("bbox",),
                          box_only=box_only(cfg), output_folder=None, bbox_aug_cfg=cfg)
                comm.synchronize()

    meters = do_train(model, optimizer, scheduler, data_loader, checkpointer, device,
                      cfg.SOLVER.CHECKPOINT_PERIOD, arguments, test_period=test_period,
                      run_validation=run_validation)
    return model, meters


def main(argv=None):
    parser = argparse.ArgumentParser(description="Mask R-CNN training (PyTorch/CUDA)")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--skip-test", dest="skip_test", action="store_true")
    parser.add_argument("--local_rank", "--local-rank", dest="local_rank", type=int, default=0)
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = default_cfg.clone()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    cfg.freeze()

    device = init_distributed(cfg)
    output_dir = cfg.OUTPUT_DIR
    if output_dir:
        mkdir(output_dir)
    logger = setup_logger("maskrcnn_tpu_torch", output_dir, comm.get_rank())
    logger.info("Using {} processes".format(comm.get_world_size()))
    logger.info("Using {} (torch {}, CUDA {})".format(
        torch.cuda.get_device_name(device) if device.type == "cuda" else "the CPU",
        torch.__version__, torch.version.cuda))
    logger.info(args)
    logger.info("Collecting env info:\n" + collect_env_info())
    if args.config_file:
        logger.info("Loaded configuration file {}".format(args.config_file))
    logger.info("Running with config:\n{}".format(cfg))
    if output_dir:
        save_config(cfg, os.path.join(output_dir, "config.yml"))
    model, meters = train(cfg, output_dir, device)
    if not args.skip_test:
        run_test(cfg, model)
    return model, meters


if __name__ == "__main__":
    main()
