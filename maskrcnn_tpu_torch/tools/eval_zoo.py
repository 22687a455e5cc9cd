"""One-command acceptance run of a zoo model.

    python -m maskrcnn_tpu_torch.tools.eval_zoo --config-file FILE [--weight W]
        [--ann-file JSON --img-dir DIR] [--output-dir DIR] [KEY VALUE ...]

Port of the JAX package's tools/eval_zoo.py: load a Detectron or zoo
checkpoint (MODEL.WEIGHT, or --weight: a catalog:// name, a URL in the
cache, a .pkl, .pth or .npz path), evaluate it on DATASETS.TEST or on the
COCO-format annotation file and image directory given (through a temporary
catalog module that serves them as "zoo_eval" and imports this package's
ModelCatalog), and hold the results to TEST.EXPECTED_RESULTS, the
reference's acceptance gate. The configs/caffe2/*.yaml files carry the
published MODEL_ZOO values there. The exit code is 0 when the gate passes
and 1 when it fails (``main`` returns it). The model runs on MODEL.DEVICE
(the card unless the configuration asks for "cpu"); TEST.BBOX_AUG applies
as in test_net.
"""

import argparse
import os
import sys
import tempfile

from ..config import cfg as default_cfg
from ..data.build import make_data_loader
from ..engine.inference import inference
from ..models.detector import build_detection_model
from ..utils.checkpoint import DetectronCheckpointer
from ..utils.logger import setup_logger
from ..utils.miscellaneous import cfg_device
from .test_net import box_only

CATALOG = (
    "class DatasetCatalog:\n"
    "    @staticmethod\n"
    "    def get(name):\n"
    "        return dict(factory='COCODataset', args=dict(\n"
    "            root={!r}, ann_file={!r},\n"
    "            remove_images_without_annotations=False))\n"
    "from maskrcnn_tpu_torch.config.paths_catalog import ModelCatalog\n"
)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Zoo model acceptance eval (PyTorch/CUDA)")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--weight", default=None,
                        help="checkpoint override (catalog://, URL or path)")
    parser.add_argument("--ann-file", default=None,
                        help="COCO-format annotation json (overrides DATASETS.TEST)")
    parser.add_argument("--img-dir", default=None)
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("opts", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = default_cfg.clone()
    cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    if args.weight:
        cfg.MODEL.WEIGHT = args.weight
    catalog = None
    if args.ann_file:
        if not args.img_dir:
            parser.error("--img-dir is required with --ann-file")
        with tempfile.NamedTemporaryFile("w", suffix="_catalog.py", delete=False) as f:
            f.write(CATALOG.format(os.path.abspath(args.img_dir), os.path.abspath(args.ann_file)))
            catalog = f.name
        cfg.PATHS_CATALOG = catalog
        cfg.DATASETS.TEST = ("zoo_eval",)
    cfg.freeze()

    output_dir = args.output_dir or os.path.join(cfg.OUTPUT_DIR or ".", "zoo_eval")
    os.makedirs(output_dir, exist_ok=True)
    logger = setup_logger("maskrcnn_tpu_torch", output_dir, 0)
    logger.info("Evaluating {} with weight {}".format(args.config_file, cfg.MODEL.WEIGHT))
    try:
        model = build_detection_model(cfg, device=cfg_device(cfg))
        DetectronCheckpointer(cfg, model, save_dir=output_dir, logger=logger).load(
            cfg.MODEL.WEIGHT)
        iou_types = ("bbox",)
        if cfg.MODEL.MASK_ON:
            iou_types = iou_types + ("segm",)
        if cfg.MODEL.KEYPOINT_ON:
            iou_types = iou_types + ("keypoints",)
        for name, loader in zip(cfg.DATASETS.TEST, make_data_loader(cfg, is_train=False)):
            inference(model, loader, dataset_name=name, iou_types=iou_types,
                      box_only=box_only(cfg), output_folder=os.path.join(output_dir, name),
                      expected_results=cfg.TEST.EXPECTED_RESULTS,
                      expected_results_sigma_tol=cfg.TEST.EXPECTED_RESULTS_SIGMA_TOL,
                      bbox_aug_cfg=cfg)
    except AssertionError as e:  # check_expected_results: the gate failed
        logger.error("zoo eval: EXPECTED_RESULTS gate failed:\n{}".format(e))
        return 1
    finally:
        if catalog:
            os.remove(catalog)
    logger.info("zoo eval complete; EXPECTED_RESULTS gate passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
