"""The port's training entry point, ``python -m maskrcnn_tpu_torch.tools.train_net``.

The CLI in a subprocess on the CPU (MODEL.DEVICE cpu), as tests/test_cli.py
runs the JAX one: a narrow Mask R-CNN R-50-FPN from the reference YAML on a
synthetic COCO tree, 2 loader workers, 4 iterations with a checkpoint every
2, then a resumed run to 6 that must load model_final and continue at
iteration 5; a unit test of the trainer's draws across such a resume. Then
what the CLI refuses: MODEL.DEVICE "tpu", and validation with test-time
augmentation (TEST.BBOX_AUG, not ported). Evaluation through train_net is
tested in test_torch_test_net.py.
"""

import os
import re
import shutil
import subprocess
import sys
import types

import pytest
import torch
import yaml

from maskrcnn_tpu_torch.engine import trainer
from maskrcnn_tpu_torch.ops.sampler import uniform_draws
from maskrcnn_tpu_torch.tools import train_net
from synthetic_coco import make_synthetic_coco

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "e2e_mask_rcnn_R_50_FPN_1x.yaml")
OPTS = [
    "MODEL.DEVICE", "cpu",
    "MODEL.WEIGHT", "",
    "MODEL.ROI_BOX_HEAD.NUM_CLASSES", "4",
    "DATASETS.TRAIN", "('coco_2017_train',)",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
    "MODEL.RESNETS.STEM_OUT_CHANNELS", "16",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "16",
    "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", "32",
    "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64",
    "MODEL.ROI_MASK_HEAD.CONV_LAYERS", "(32, 32, 32, 32)",
    "TPU.COMPUTE_DTYPE", "float32",
    "INPUT.PIXEL_STD", "[57.375, 57.12, 58.395]",
    "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", "200",
    "MODEL.RPN.POST_NMS_TOP_N_TRAIN", "100",
    "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", "128",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "64",
    "INPUT.MIN_SIZE_TRAIN", "(120,)",
    "INPUT.MAX_SIZE_TRAIN", "160",
    "SOLVER.IMS_PER_BATCH", "2",
    "SOLVER.BASE_LR", "0.0001",
    "TPU.MAX_GT_BOXES", "8",
    "DATALOADER.NUM_WORKERS", "2",
    "SOLVER.CHECKPOINT_PERIOD", "2",
]


def _data_tree(tmp_path):
    root = tmp_path / "datasets"
    img_dir, ann_file = make_synthetic_coco(str(tmp_path / "gen"), num_images=6, num_classes=3)
    (root / "coco" / "annotations").mkdir(parents=True)
    shutil.move(img_dir, str(root / "coco" / "train2017"))
    shutil.move(ann_file, str(root / "coco" / "annotations" / "instances_train2017.json"))
    return root


def _run(args, data_root):
    env = dict(os.environ, MASKRCNN_TPU_DATA_DIR=str(data_root), CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join([REPO, env.get("PYTHONPATH", "")])
    return subprocess.run([sys.executable, "-m", "maskrcnn_tpu_torch.tools.train_net"] + args,
                          env=env, capture_output=True, text=True, timeout=300, cwd=REPO)


def test_train_net_trains_saves_and_resumes(tmp_path):
    data_root = _data_tree(tmp_path)
    out = tmp_path / "out"
    args = ["--config-file", CONFIG, "--skip-test"] + OPTS + [
        "SOLVER.MAX_ITER", "4", "OUTPUT_DIR", str(out)]
    r = _run(args, data_root)
    assert r.returncode == 0, r.stderr[-3000:]
    for name in ("model_0000002.pth", "model_0000004.pth", "model_final.pth", "last_checkpoint",
                 "config.yml", "labels.json", "log.txt"):
        assert (out / name).exists(), (name, os.listdir(out))
    log = r.stdout + r.stderr
    assert [int(m) for m in re.findall(r"iter: (\d+)", log)] == [4]
    assert "nan" not in log.split("iter: 4")[-1][:600]
    with open(out / "config.yml") as f:
        saved = yaml.safe_load(f)
    assert saved["MODEL"]["DEVICE"] == "cpu" and saved["SOLVER"]["MAX_ITER"] == 4

    args[args.index("SOLVER.MAX_ITER") + 1] = "6"
    r2 = _run(args, data_root)
    assert r2.returncode == 0, r2.stderr[-3000:]
    log2 = r2.stdout + r2.stderr
    assert re.search(r"Loading checkpoint from .*model_final\.pth", log2), log2[-2000:]
    assert [int(m) for m in re.findall(r"iter: (\d+)", log2)] == [6]
    assert (out / "model_0000006.pth").exists()


class _Loader:
    """The iteration-based loader's shape: len() is the last iteration, and
    a loader resumed after `start` yields the batches from start + 1."""

    def __init__(self, start, total):
        self.start, self.total = start, total

    def __len__(self):
        return self.total

    def __iter__(self):
        for _ in range(self.total - self.start):
            yield {"gt_labels": torch.ones(1, 2, dtype=torch.int32)}


def _recorded_draws(monkeypatch, start, total):
    """The samplers' draws of each iteration do_train runs after `start`,
    taken from the generator it hands the step, as train_forward takes them."""
    draws = []

    def make_train_step(model, optimizer, scheduler, generator=None):
        def step(batch):
            draws.append(torch.cat(uniform_draws((2, 8), generator, "cpu")))
            return {"loss": torch.zeros(())}
        return step

    monkeypatch.setattr(trainer, "make_train_step", make_train_step)
    saver = types.SimpleNamespace(save=lambda name, **kw: None)
    optimizer = types.SimpleNamespace(param_groups=[{"lr": 0.01}])
    trainer.do_train(None, optimizer, None, _Loader(start, total), saver, torch.device("cpu"),
                     2, {"iteration": start})
    return draws


def test_resumed_training_draws_what_a_straight_run_draws(monkeypatch):
    """A run resumed after iteration 4 draws at iterations 5 and 6 what a
    straight run to 6 draws there (the JAX trainer folds the iteration into
    its key), and no iteration repeats another's draws."""
    straight = _recorded_draws(monkeypatch, 0, 6)
    resumed = _recorded_draws(monkeypatch, 4, 6)
    assert len(straight) == 6 and len(resumed) == 2
    for got, want in zip(resumed, straight[4:]):
        assert torch.equal(got, want)
    assert all(not torch.equal(a, b) for i, a in enumerate(straight) for b in straight[i + 1:])


@pytest.mark.parametrize("opts,error", [
    (["MODEL.DEVICE", "tpu"], ValueError),
    (["MODEL.DEVICE", "cpu", "TPU.MESH_AXES", "('data', 'model')", "TPU.MESH_SHAPE", "(1, 2)"],
     ValueError),
    (["MODEL.DEVICE", "cpu", "TPU.MESH_AXES", "('data', 'expert')", "TPU.MESH_SHAPE", "(1, 1)"],
     ValueError),
])
def test_train_net_rejects_what_the_port_lacks(tmp_path, monkeypatch, opts, error):
    """A device the port does not run on; a mesh that one process cannot
    fill (a "model" axis of 2: tests/test_torch_mesh.py trains on one), and
    an axis neither "data" nor "model". Test-time augmentation, which the
    second case named until the port had it, validates instead
    (test_train_net_validates_with_tta)."""
    data_root = _data_tree(tmp_path)
    monkeypatch.setenv("MASKRCNN_TPU_DATA_DIR", str(data_root))
    with pytest.raises(error):
        train_net.main(["--config-file", CONFIG, "--skip-test"] + OPTS + opts + [
            "SOLVER.MAX_ITER", "2", "OUTPUT_DIR", str(tmp_path / "out"),
            "DATALOADER.NUM_WORKERS", "0"])


def test_train_net_validates_with_tta(tmp_path, monkeypatch):
    """SOLVER.TEST_PERIOD with TEST.BBOX_AUG.ENABLED: the validation loader
    hands untransformed images to the augmented passes (two here: the test
    size and its flip), bbox only."""
    from maskrcnn_tpu_torch.engine import bbox_aug

    data_root = _data_tree(tmp_path)
    monkeypatch.setenv("MASKRCNN_TPU_DATA_DIR", str(data_root))
    passes = []
    run = bbox_aug.im_detect_bbox

    def counted(model, images, scale, max_size, cfg, hflip=False):
        passes.append((len(images), scale, hflip))
        return run(model, images, scale, max_size, cfg, hflip)

    monkeypatch.setattr(bbox_aug, "im_detect_bbox", counted)
    train_net.main(["--config-file", CONFIG, "--skip-test"] + OPTS + [
        "MODEL.DEVICE", "cpu", "SOLVER.TEST_PERIOD", "2", "DATASETS.TEST", "('coco_2017_train',)",
        "TEST.BBOX_AUG.ENABLED", "True", "TEST.BBOX_AUG.H_FLIP", "True", "SOLVER.MAX_ITER", "2",
        "OUTPUT_DIR", str(tmp_path / "out"), "DATALOADER.NUM_WORKERS", "0"])
    sizes = [p[1] for p in passes]
    assert sum(p[0] for p in passes) == 2 * 6 and [p[2] for p in passes][:2] == [False, True]
    assert len(set(sizes)) == 1
