"""The port's evaluation entry points on the CPU (MODEL.DEVICE cpu).

* ``engine.inference.inference`` end to end against the JAX package's
  ``inference``: a narrow Mask R-CNN R-50-FPN with the same weights
  (params_from_jax), the same synthetic COCO val tree of 5 images at batch 2
  (the last batch holds one image). The images are at the test size, so
  neither package resizes them and both models see the same bytes. Per
  image the detections agree at the tolerances of test_torch_detector.py
  (labels exact, scores 1e-5, boxes 1e-3 px, mask probabilities 1e-4); bbox
  AP within 1e-3 absolute.
* ``python -m maskrcnn_tpu_torch.tools.test_net --ckpt`` in a subprocess on
  a JAX package checkpoint (.npz), as tests/test_cli.py runs the JAX CLI.
* ``train_net`` without ``--skip-test``: validation every
  SOLVER.TEST_PERIOD iterations (bbox), then the final test (bbox, segm).
* ``do_train`` calling ``run_validation`` at the period, resumed runs too.
"""

import logging
import os
import pickle
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax

from maskrcnn_tpu.config.paths_catalog import DatasetCatalog as JaxCatalog
from maskrcnn_tpu.data import make_data_loader as jax_make_data_loader
from maskrcnn_tpu.engine.inference import inference as jax_inference
from maskrcnn_tpu.models import build_detection_model as build_jax_model
from maskrcnn_tpu.utils.checkpoint import Checkpointer as JaxCheckpointer
from maskrcnn_tpu_torch.data.build import make_data_loader
from maskrcnn_tpu_torch.engine import trainer
from maskrcnn_tpu_torch.engine.inference import inference
from maskrcnn_tpu_torch.models import build_detection_model
from maskrcnn_tpu_torch.tools import train_net
from maskrcnn_tpu_torch.utils.convert import params_from_jax
from synthetic_coco import make_synthetic_coco
from torch_port_fixtures import configs, numpy_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "e2e_mask_rcnn_R_50_FPN_1x.yaml")
# test_torch_train_net.py's narrow widths, at the tree's image size for testing
OPTS = [
    "MODEL.DEVICE", "cpu", "MODEL.WEIGHT", "", "MODEL.ROI_BOX_HEAD.NUM_CLASSES", "4",
    "DATASETS.TRAIN", "('coco_2017_train',)", "DATASETS.TEST", "('coco_2017_val',)",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "64", "MODEL.RESNETS.STEM_OUT_CHANNELS", "16",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "16", "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", "32",
    "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64", "MODEL.ROI_MASK_HEAD.CONV_LAYERS", "(32, 32, 32, 32)",
    "TPU.COMPUTE_DTYPE", "float32", "INPUT.PIXEL_STD", "[57.375, 57.12, 58.395]",
    "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", "200", "MODEL.RPN.POST_NMS_TOP_N_TRAIN", "100",
    "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", "128", "MODEL.RPN.PRE_NMS_TOP_N_TEST", "200",
    "MODEL.RPN.POST_NMS_TOP_N_TEST", "100", "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", "100",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "64", "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", "10",
    "INPUT.MIN_SIZE_TRAIN", "(120,)", "INPUT.MAX_SIZE_TRAIN", "160",
    "INPUT.MIN_SIZE_TEST", "120", "INPUT.MAX_SIZE_TEST", "160",
    "SOLVER.IMS_PER_BATCH", "2", "SOLVER.BASE_LR", "0.0001", "TEST.IMS_PER_BATCH", "2",
    "TPU.MAX_GT_BOXES", "8", "DATALOADER.NUM_WORKERS", "1",
]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """coco_2017_train and coco_2017_val of the catalogs: the same 5 images
    of 120x160 and 3 classes."""
    tmp = tmp_path_factory.mktemp("test_net")
    root = tmp / "datasets"
    img_dir, ann_file = make_synthetic_coco(str(tmp / "gen"), num_images=5, num_classes=3,
                                            seed=2)
    (root / "coco" / "annotations").mkdir(parents=True)
    shutil.move(img_dir, str(root / "coco" / "val2017"))
    shutil.copytree(str(root / "coco" / "val2017"), str(root / "coco" / "train2017"))
    for split in ("val2017", "train2017"):
        shutil.copy(ann_file, str(root / "coco" / "annotations" / "instances_{}.json".format(split)))
    return root


def _eval_configs():
    jcfg, tcfg = configs()
    for c in (jcfg, tcfg):
        c.MODEL.ROI_BOX_HEAD.NUM_CLASSES = 4
        c.DATASETS.TEST = ("coco_2017_val",)
        c.INPUT.MIN_SIZE_TEST, c.INPUT.MAX_SIZE_TEST = 120, 160
        c.TEST.IMS_PER_BATCH = 2
        c.DATALOADER.NUM_WORKERS = 0
    tcfg.MODEL.DEVICE = "cpu"
    return jcfg, tcfg


def test_inference_matches_jax(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(JaxCatalog, "DATA_DIR", str(tree))
    monkeypatch.setenv("MASKRCNN_TPU_DATA_DIR", str(tree))
    jcfg, tcfg = _eval_configs()
    jm = build_jax_model(jcfg)
    params = numpy_params(jm)
    tm = build_detection_model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(params), strict=True)

    (jloader,) = jax_make_data_loader(jcfg, is_train=False)
    (tloader,) = make_data_loader(tcfg, is_train=False)
    tbatches, jbatches = list(tloader), list(jloader)
    assert [len(b["indices"]) for b in tbatches] == [2, 2, 1]
    for t, j in zip(tbatches, jbatches):
        for k in ("images", "image_sizes", "indices"):
            np.testing.assert_array_equal(t[k].numpy(), j[k], err_msg=k)

    kw = dict(dataset_name="coco_2017_val", iou_types=("bbox", "segm"))
    want, _ = jax_inference(jm, jax.tree.map(np.asarray, params), jloader,
                            output_folder=str(tmp_path / "jax"), **kw)
    got, _ = inference(tm, tloader, output_folder=str(tmp_path / "torch"), **kw)
    preds = []
    for side in ("jax", "torch"):
        with open(tmp_path / side / "predictions.pkl", "rb") as f:
            preds.append(pickle.load(f))
    want_p, got_p = preds
    assert len(got_p) == len(want_p) == 5
    assert sum(len(p) for p in got_p) >= 20
    for g, w in zip(got_p, want_p):
        assert g.size == w.size == (160, 120) and len(g) == len(w)
        np.testing.assert_array_equal(g.get_field("labels"), w.get_field("labels"))
        np.testing.assert_allclose(g.get_field("scores"), w.get_field("scores"),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.bbox, w.bbox, rtol=0, atol=1e-3)
        np.testing.assert_allclose(g.get_field("mask"), w.get_field("mask"),
                                   rtol=1e-4, atol=1e-4)
    for k, v in want.results["bbox"].items():
        assert abs(got.results["bbox"][k] - v) <= 1e-3, (k, got.results["bbox"][k], v)
    assert set(got.results) == {"bbox", "segm"}


def test_test_net_cli_on_a_jax_checkpoint(tree, tmp_path):
    """test_net in a subprocess with --ckpt naming the JAX package's .npz of
    the same configuration; predictions land in OUTPUT_DIR/inference."""
    from maskrcnn_tpu.config import cfg as jax_cfg

    c = jax_cfg.clone()
    c.merge_from_file(CONFIG)
    c.merge_from_list([v for i in range(0, len(OPTS), 2) for v in OPTS[i:i + 2]
                       if OPTS[i] != "MODEL.DEVICE"])
    jm = build_jax_model(c)
    JaxCheckpointer(save_dir=str(tmp_path), save_to_disk=True).save(
        "weights", numpy_params(jm, seed=1))
    out = tmp_path / "out"
    env = dict(os.environ, MASKRCNN_TPU_DATA_DIR=str(tree), CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    r = subprocess.run(
        [sys.executable, "-m", "maskrcnn_tpu_torch.tools.test_net", "--config-file", CONFIG,
         "--ckpt", str(tmp_path / "weights.npz")] + OPTS + ["OUTPUT_DIR", str(out)],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    log = r.stdout + r.stderr
    assert "Loading checkpoint from " + str(tmp_path / "weights.npz") in log
    for line in ("Start evaluation on coco_2017_val dataset(5 images).", "Model inference time",
                 "Evaluating predictions: bbox", "Evaluating predictions: segm", "Task: segm"):
        assert line in log, (line, log[-2000:])
    with open(out / "inference" / "coco_2017_val" / "predictions.pkl", "rb") as f:
        preds = pickle.load(f)
    assert len(preds) == 5 and sum(len(p) for p in preds) > 0


class _LogLines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_train_net_validates_and_tests(tree, tmp_path, monkeypatch):
    """train_net without --skip-test, SOLVER.TEST_PERIOD 2 over 4 iterations:
    bbox validation after iterations 2 and 4, then the final test with
    bbox and segm and its predictions file (in this process, which has
    JAX's threads: no loader workers, so nothing forks)."""
    monkeypatch.setenv("MASKRCNN_TPU_DATA_DIR", str(tree))
    logs = _LogLines()
    logger = logging.getLogger("maskrcnn_tpu_torch")
    logger.addHandler(logs)
    try:
        train_net.main(["--config-file", CONFIG] + OPTS + [
            "SOLVER.MAX_ITER", "4", "SOLVER.TEST_PERIOD", "2", "SOLVER.CHECKPOINT_PERIOD", "4",
            "DATALOADER.NUM_WORKERS", "0", "OUTPUT_DIR", str(tmp_path / "out")])
    finally:
        logger.removeHandler(logs)
    lines = logs.lines
    marks = [line for line in lines if line.startswith(("Validation at iteration",
                                                        "Evaluating predictions"))]
    assert marks == ["Validation at iteration 2", "Evaluating predictions: bbox",
                     "Validation at iteration 4", "Evaluating predictions: bbox",
                     "Evaluating predictions: bbox", "Evaluating predictions: segm"], marks
    assert sum("Start evaluation on coco_2017_val dataset(5 images)." in x for x in lines) == 3
    assert (tmp_path / "out" / "inference" / "coco_2017_val" / "predictions.pkl").exists()
    assert (tmp_path / "out" / "model_final.pth").exists()


class _Loader:
    def __init__(self, start, total):
        self.start, self.total = start, total

    def __len__(self):
        return self.total

    def __iter__(self):
        for _ in range(self.total - self.start):
            yield {"gt_labels": torch.ones(1, 2, dtype=torch.int32)}


@pytest.mark.parametrize("start,total,period,want", [
    (0, 6, 2, [2, 4, 6]), (3, 7, 2, [4, 6]), (0, 5, 0, []), (0, 3, 5, []),
])
def test_do_train_validates_at_the_period(monkeypatch, start, total, period, want):
    monkeypatch.setattr(trainer, "make_train_step",
                        lambda *a, **k: lambda batch: {"loss": torch.zeros(())})
    seen = []
    model = object()
    saver = types.SimpleNamespace(save=lambda name, **kw: None)
    optimizer = types.SimpleNamespace(param_groups=[{"lr": 0.01}])
    trainer.do_train(model, optimizer, None, _Loader(start, total), saver, torch.device("cpu"),
                     100, {"iteration": start}, test_period=period,
                     run_validation=lambda m, it: seen.append((m, it)))
    assert seen == [(model, it) for it in want]


CAFFE2 = os.path.join(REPO, "configs", "caffe2", "e2e_mask_rcnn_R_50_FPN_1x_caffe2.yaml")


@pytest.mark.parametrize("gate", ["passes", "fails"])
def test_eval_zoo_gate(tmp_path, gate):
    """tools/eval_zoo.py's main on the caffe2 Mask R-CNN config (narrow, on
    the CPU) with a synthetic Detectron model_final.pkl of the same model
    and a COCO tree through --ann-file/--img-dir: exit 0 when
    TEST.EXPECTED_RESULTS holds, 1 when it does not."""
    from chip_smoke import detectron_blobs, write_pkl
    from maskrcnn_tpu_torch.config import cfg as torch_defaults
    from maskrcnn_tpu_torch.tools import eval_zoo

    img_dir, ann_file = make_synthetic_coco(str(tmp_path / "data"), num_images=4,
                                            num_classes=3, seed=5)
    opts = [v for i in range(0, len(OPTS), 2) for v in OPTS[i:i + 2]
            if OPTS[i] not in ("MODEL.WEIGHT", "DATASETS.TRAIN", "DATASETS.TEST")]
    c = torch_defaults.clone()
    c.merge_from_file(CAFFE2)
    c.merge_from_list(opts)
    state = {k: v.numpy() for k, v in build_detection_model(c, device="cpu", seed=3)
             .state_dict().items()}
    weight = str(tmp_path / "model_final.pkl")
    write_pkl(weight, detectron_blobs(np, state), wrap=True)
    expected = [["bbox", "AP", 0.5, 0.2]] if gate == "passes" else [["bbox", "AP", 2.0, 0.01]]
    logs = _LogLines()
    logger = logging.getLogger("maskrcnn_tpu_torch")
    logger.addHandler(logs)
    try:
        rc = eval_zoo.main(["--config-file", CAFFE2, "--weight", weight, "--ann-file", ann_file,
                            "--img-dir", img_dir, "--output-dir", str(tmp_path / "out")]
                           + opts + ["DATALOADER.NUM_WORKERS", "0",
                                     "TEST.EXPECTED_RESULTS", repr(expected)])
    finally:
        logger.removeHandler(logs)
    assert rc == (0 if gate == "passes" else 1)
    text = "\n".join(logs.lines)
    assert "Start evaluation on zoo_eval dataset(4 images)." in text
    assert "bbox > AP sanity check {}".format("passed" if gate == "passes" else "FAILED") in text
    assert (tmp_path / "out" / "zoo_eval" / "predictions.pkl").exists()
    assert "Loading checkpoint from {}".format(weight) in text
