"""Which published configs the port builds: GeneralizedRCNN from each of the
66 files under configs/ on the meta device (no memory, no weights). 49
build; the 17 that raise NotImplementedError are exactly the three model
families still to port (ROADMAP.md Queue 1): FBNet (7 files), RPN-only (6)
and deformable convs (4). The port's config reader takes the files
without PyYAML (config/cfgnode.py)."""

import glob
import os

import pytest
import torch

from maskrcnn_tpu_torch.config import cfg as defaults
from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(os.path.relpath(p, os.path.join(REPO, "configs"))
               for p in glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))


def _family(cfg):
    """The family that does not build yet, or None."""
    if cfg.MODEL.BACKBONE.CONV_BODY.startswith("FBNet"):
        return "fbnet"
    if cfg.MODEL.RPN_ONLY and not cfg.MODEL.RETINANET_ON:
        return "rpn_only"
    if any(cfg.MODEL.RESNETS.STAGE_WITH_DCN):
        return "dcn"
    return None


def _cfg(name):
    c = defaults.clone()
    c.merge_from_file(os.path.join(REPO, "configs", name))
    return c


@pytest.mark.parametrize("name", FILES)
def test_config_builds_on_the_meta_device_unless_its_family_waits(name):
    cfg = _cfg(name)
    family = _family(cfg)
    if family is None:
        with torch.device("meta"):
            model = GeneralizedRCNN(cfg)
        assert all(p.is_meta for p in model.parameters())
        return
    with pytest.raises(NotImplementedError, match={"fbnet": "FBNet", "rpn_only": "RPN-only",
                                                   "dcn": "deformable"}[family]):
        with torch.device("meta"):
            GeneralizedRCNN(cfg)


def test_49_of_66_configs_build_and_the_rest_are_fbnet_rpn_only_and_dcn():
    assert len(FILES) == 66
    families = [_family(_cfg(name)) for name in FILES]
    assert families.count(None) == 49
    assert {f: families.count(f) for f in ("fbnet", "rpn_only", "dcn")} == {
        "fbnet": 7, "rpn_only": 6, "dcn": 4}
    built = {name for name, f in zip(FILES, families) if f is None}
    # this slice's families are among them: the GN baselines and the C4 files
    assert sum(name.startswith("gn_baselines/") for name in built) == 8
    assert sum("_C4_" in name and "rpn_" not in name for name in built) == 8
