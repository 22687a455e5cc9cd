"""The PyTorch port stands alone: no JAX, nothing of maskrcnn_tpu, no PyYAML,
OpenCV or Pillow once every module is imported (Pillow only inside the
dataset loaders the card overrides); it reads the config files without
PyYAML, as PyYAML reads them; and chip_smoke.py refuses to report without a
card or without the repository around it."""

import json
import os
import pkgutil
import shutil
import subprocess
import sys

import pytest

import maskrcnn_tpu_torch
from __graft_entry__ import _flagship_cfg
from maskrcnn_tpu_torch.config import flagship_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, cwd=REPO):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_neither_jax_nor_the_jax_package():
    modules = sorted(m.name for m in pkgutil.walk_packages(
        maskrcnn_tpu_torch.__path__, "maskrcnn_tpu_torch."))
    for name in ("ops.nms", "parallel.distributed", "utils.c2_loading", "utils.model_zoo",
                 "utils.model_serialization", "data.datasets.voc", "data.datasets.cityscapes",
                 "data.datasets.concat", "data.evaluation.voc_eval",
                 "data.evaluation.cityscapes_eval", "models.roi_heads.keypoint_head",
                 "structures.keypoints", "engine.bbox_aug", "demo.predictor", "demo.draw",
                 "demo.webcam", "tools.eval_zoo", "structures.image_list", "models.registry",
                 "utils.registry", "utils.collect_env", "utils.env", "utils.imports"):
        assert "maskrcnn_tpu_torch." + name in modules
    code = (
        "import importlib, sys\n"
        "for m in {!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "from maskrcnn_tpu_torch.config import cfg\n"
        "sys.modules['yaml'] = None  # a config file reads without PyYAML\n"
        "cfg.clone().merge_from_file('configs/cityscapes/e2e_mask_rcnn_R_50_FPN_1x_poly.yaml')\n"
        "del sys.modules['yaml']\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'maskrcnn_tpu', 'yaml', 'cv2', 'PIL')]\n"
        "print(bad)\n"
    ).format(modules)
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.parametrize("tiny", [False, True])
def test_flagship_config_matches_jax(tiny):
    import yaml

    ours, theirs = flagship_cfg(tiny), _flagship_cfg(tiny)
    # the one path-valued key names each package's own dataset catalog file
    ours.PATHS_CATALOG = theirs.PATHS_CATALOG
    # the port's one difference: it runs on "cuda" (or "cpu"), never "tpu"
    assert ours.MODEL.DEVICE == "cuda" and theirs.MODEL.DEVICE == "tpu"
    ours.MODEL.DEVICE = theirs.MODEL.DEVICE
    # the port writes its YAML without PyYAML (and without PyYAML's anchors
    # for shared tuples): the same tree must read back
    assert yaml.safe_load(ours.dump()) == yaml.safe_load(theirs.dump())
    assert ours._to_plain() == theirs._to_plain()


def test_config_reads_yaml_on_demand(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text("MODEL:\n  MASK_ON: False\nINPUT:\n  MIN_SIZE_TEST: 600\n")
    c = flagship_cfg()
    c.merge_from_file(str(path))
    assert not c.MODEL.MASK_ON and c.INPUT.MIN_SIZE_TEST == 600


def test_config_files_read_as_pyyaml_reads_them():
    """Every YAML file under configs/ gives the port's loader the tree that
    yaml.safe_load gives, once both go through the values' decoding."""
    import glob

    import yaml

    from maskrcnn_tpu_torch.config.cfgnode import _decode_value, load_yaml

    def decoded(tree):
        if isinstance(tree, dict):
            return {k: decoded(v) for k, v in tree.items()}
        return _decode_value(tree)

    files = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))
    assert len(files) >= 60
    for path in files:
        with open(path) as f:
            text = f.read()
        assert decoded(load_yaml(text)) == decoded(yaml.safe_load(text) or {}), path


def _last_line_ok(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return json.loads(lines[-1]).get("ok") is True
    except ValueError:
        return False


def test_chip_smoke_fails_without_a_card():
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert not _last_line_ok(proc.stdout)


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert not _last_line_ok(proc.stdout)
