"""Which published configs the port builds: GeneralizedRCNN from each of the
66 files under configs/ on the meta device (no memory, no weights). All 66
build; the last three families to come, FBNet (7 files), RPN-only (6) and
deformable convs (4), build with their own modules: the FBNet body and
heads, no ROI heads, the offset convs of layer2-4. The port's config reader
takes the files without PyYAML (config/cfgnode.py)."""

import glob
import os

import pytest
import torch

from maskrcnn_tpu_torch.config import cfg as defaults
from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN
from maskrcnn_tpu_torch.models.fbnet import FBNetBackbone, FBNetRPNHead

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(os.path.relpath(p, os.path.join(REPO, "configs"))
               for p in glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))


def _family(cfg):
    """The family among the last three to be ported, or None."""
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
    """No family waits any more: every file builds, each of the last three
    with its own modules."""
    cfg = _cfg(name)
    with torch.device("meta"):
        model = GeneralizedRCNN(cfg)
    assert all(p.is_meta for p in model.parameters())
    family = _family(cfg)
    names = [n for n, _ in model.named_parameters()]
    if family == "fbnet":
        assert isinstance(model.backbone, FBNetBackbone) and isinstance(model.rpn, FBNetRPNHead)
        assert any(n.startswith("roi_heads.box.feature_extractor.blocks.") for n in names)
    elif family == "rpn_only":
        assert not hasattr(model, "roi_heads") and not any(n.startswith("roi_heads") for n in names)
    elif family == "dcn":
        taps = 27 if cfg.MODEL.RESNETS.WITH_MODULATED_DCN else 18
        offsets = [p for n, p in model.named_parameters() if n.endswith("conv2_offset.weight")]
        assert len(offsets) == 13 and all(p.shape[0] == taps for p in offsets)
    else:
        assert not any("conv2_offset" in n for n in names)


def test_49_of_66_configs_build_and_the_rest_are_fbnet_rpn_only_and_dcn():
    """The 49 files that built before the last three families came, and the
    rest, FBNet, RPN-only and DCN: now 66 of 66 build."""
    assert len(FILES) == 66
    families = [_family(_cfg(name)) for name in FILES]
    assert families.count(None) == 49
    assert {f: families.count(f) for f in ("fbnet", "rpn_only", "dcn")} == {
        "fbnet": 7, "rpn_only": 6, "dcn": 4}
    built = set()
    for name in FILES:
        with torch.device("meta"):
            GeneralizedRCNN(_cfg(name))
        built.add(name)
    assert len(built) == 66
    # the GN baselines and the C4 files among them
    assert sum(name.startswith("gn_baselines/") for name in built) == 8
    assert sum("_C4_" in name and "rpn_" not in name for name in built) == 8
