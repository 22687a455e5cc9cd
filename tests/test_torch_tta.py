"""Test-time augmentation in the port (engine/bbox_aug.py, the TTA loader and
``inference(..., bbox_aug_cfg=cfg)``) against the JAX package's.

* The merge: the same per-pass BoxLists give the same kept detections in
  the same order (float64 NMS over every label together), near-threshold
  pairs included.
* The passes: the same list and the same sizes for both orientations of the
  published TTA file; a pass's input within one grey level of the JAX
  package's Pillow resize (the bound of data/transforms.py).
* ``im_detect_bbox``: the same weights and the same images at their own size
  (so both packages hand the model the same bytes), each pass and its flip:
  labels exact, scores 1e-5, boxes 1e-3 px.
* ``inference`` end to end on a synthetic COCO tree of 5 images at their own
  size, four passes: the same merged detections and bbox AP within 1e-3.
* Witnesses of the JAX package's own TTA (ROADMAP.md Queue 3): its merge
  keeps each pass's 28 x 28 mask probabilities unflipped (BoxList.transpose
  leaves an array field as it is), so its "segm" evaluation of a flipped
  pass's detections pastes the mirror image of their masks; its keypoint
  field cannot be concatenated. The port answers "bbox" alone and raises
  ValueError for any other iou type before its first pass.
"""

import os
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskrcnn_tpu.config.paths_catalog import DatasetCatalog as JaxCatalog
from maskrcnn_tpu.data import make_data_loader as jax_make_data_loader
from maskrcnn_tpu.data.transforms import Resize as JaxResize
from maskrcnn_tpu.engine import bbox_aug as jax_bbox_aug
from maskrcnn_tpu.engine.inference import DetectionKeypoints as JaxDetectionKeypoints
from maskrcnn_tpu.engine.inference import inference as jax_inference
from maskrcnn_tpu.models import build_detection_model as build_jax_model
from maskrcnn_tpu.structures import cat_boxlist as jax_cat_boxlist
from maskrcnn_tpu.structures.boxlist import FLIP_LEFT_RIGHT as JAX_FLIP
from maskrcnn_tpu.structures.boxlist import BoxList as JaxBoxList
from maskrcnn_tpu.structures.boxlist_ops import boxlist_nms as jax_boxlist_nms
from maskrcnn_tpu_torch.config import cfg as torch_defaults
from maskrcnn_tpu_torch.data.build import make_data_loader
from maskrcnn_tpu_torch.engine import bbox_aug
from maskrcnn_tpu_torch.engine.inference import inference
from maskrcnn_tpu_torch.models import build_detection_model
from maskrcnn_tpu_torch.structures import BoxList
from maskrcnn_tpu_torch.structures.boxlist_ops import boxlist_nms, remove_small_boxes
from maskrcnn_tpu_torch.utils.convert import params_from_jax
from synthetic_coco import make_synthetic_coco
from torch_port_fixtures import configs, numpy_params, random_boxes

PIL = pytest.importorskip("PIL.Image")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TTA_FILE = os.path.join(REPO, "configs", "test_time_aug", "e2e_mask_rcnn_R_50_FPN_1x.yaml")


def _boxlists(rs, n, size=(160, 120)):
    """A JAX and a port BoxList of the same n detections and n // 4 more:
    copies of the first ones widened to an IoU with them of 0.5 within the
    float32 rounding of their corners."""
    boxes = random_boxes(rs, n, 10, 110, 4, 60).astype(np.float64)
    k = n // 4
    w = boxes[:k, 2] - boxes[:k, 0] + 1
    eps = rs.choice([-1e-9, 1e-9], k)
    twin = boxes[:k].copy()
    twin[:, 2] = boxes[:k, 0] + w / (0.5 + eps) - 1
    boxes = np.concatenate([boxes, twin])
    scores = np.round(rs.uniform(0, 1, len(boxes)), 2).astype(np.float32)  # ties
    labels = rs.randint(1, 4, len(boxes))
    out = []
    for cls in (JaxBoxList, BoxList):
        bl = cls(boxes.astype(np.float32), size, mode="xyxy")
        bl.add_field("scores", scores)
        bl.add_field("labels", labels)
        out.append(bl)
    return out


def test_merge_matches_jax_exactly():
    rs = np.random.RandomState(0)
    cfg = torch_defaults.clone()
    cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG = 40
    for _ in range(5):
        passes = [_boxlists(rs, rs.randint(8, 40)) for _ in range(6)]
        want = jax_boxlist_nms(jax_cat_boxlist([p[0] for p in passes]), cfg.MODEL.ROI_HEADS.NMS,
                               max_proposals=40)
        got = bbox_aug.merge_passes([p[1] for p in passes], cfg)
        assert len(got) == len(want) <= 40
        np.testing.assert_array_equal(got.bbox, want.bbox)
        for f in ("scores", "labels"):
            np.testing.assert_array_equal(got.get_field(f), want.get_field(f))
    # class-agnostic: a box of another label is suppressed all the same
    a, b = _boxlists(np.random.RandomState(1), 4)
    for bl in (a, b):
        bl.bbox[1] = bl.bbox[0]
        bl.get_field("labels")[:2] = [1, 2]
        bl.get_field("scores")[:2] = [0.9, 0.8]
    assert len(boxlist_nms(b, 0.5)) == len(jax_boxlist_nms(a, 0.5)) < len(b)
    small = remove_small_boxes(b, 30)
    assert all(((bb[2:] - bb[:2] + 1) >= 30).all() for bb in small.bbox)


@pytest.mark.parametrize("hw", [(480, 640), (640, 480)])
def test_passes_and_sizes_match_jax(hw, monkeypatch):
    cfg = torch_defaults.clone()
    cfg.merge_from_file(TTA_FILE)
    calls = []

    def record(model, params, images, scale, max_size, device_infer, c, hflip=False):
        calls.append((scale, max_size, hflip))
        out = [JaxBoxList(np.zeros((0, 4), np.float32), im.size) for im in images]
        for bl in out:
            bl.add_field("scores", np.zeros(0, np.float32))
        return out

    monkeypatch.setattr(jax_bbox_aug, "im_detect_bbox", record)
    jax_bbox_aug.im_detect_bbox_aug(None, None, [PIL.new("RGB", hw[::-1])], None, cfg)
    passes = bbox_aug.tta_passes(cfg)
    assert passes == calls and len(passes) == 18
    assert passes[:2] == [(800, 1333, False), (800, 1333, True)]
    assert [p[0] for p in passes[2::2]] == [400, 500, 600, 700, 900, 1000, 1100, 1200]
    blank = np.zeros(hw + (3,), np.uint8)
    for scale, max_size, hflip in passes:
        want = JaxResize(scale, max_size).get_size(hw[::-1])
        padded, sizes = bbox_aug.pass_input(blank, scale, max_size, cfg, hflip)
        assert tuple(sizes[0]) == want
        assert padded.shape[1:3] == tuple(-(-v // 32) * 32 for v in want)
    # a resized pass's input is the JAX package's within one grey level
    rs = np.random.RandomState(2)
    rgb = rs.randint(0, 256, (60, 80, 3)).astype(np.uint8)
    small = cfg.clone()
    small.INPUT.MIN_SIZE_TEST = 45
    padded, sizes = bbox_aug.pass_input(rgb, 45, 100, small, hflip=True)
    pil = PIL.fromarray(rgb).transpose(PIL.FLIP_LEFT_RIGHT).resize((60, 45), PIL.BILINEAR)
    bgr = np.asarray(pil, np.float32)[:, :, ::-1]
    ours = padded[0, :45, :60] * np.asarray(cfg.INPUT.PIXEL_STD) + np.asarray(cfg.INPUT.PIXEL_MEAN)
    assert sizes.tolist() == [[45, 60]] and padded.shape == (1, 64, 64, 3)
    assert np.abs(ours - bgr).max() <= 1 + 1e-3


def _eval_configs():
    jcfg, tcfg = configs()
    for c in (jcfg, tcfg):
        c.MODEL.ROI_BOX_HEAD.NUM_CLASSES = 4
        c.DATASETS.TEST = ("coco_2017_val",)
        c.INPUT.MIN_SIZE_TEST, c.INPUT.MAX_SIZE_TEST = 120, 160
        c.TEST.IMS_PER_BATCH = 2
        c.DATALOADER.NUM_WORKERS = 0
        c.TEST.BBOX_AUG.ENABLED = True
        c.TEST.BBOX_AUG.H_FLIP = True
        c.TEST.BBOX_AUG.SCALES = (120,)
        c.TEST.BBOX_AUG.MAX_SIZE = 160
        c.TEST.BBOX_AUG.SCALE_H_FLIP = True
    tcfg.MODEL.DEVICE = "cpu"
    return jcfg, tcfg


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = _eval_configs()
    jm = build_jax_model(jcfg)
    params = numpy_params(jm)
    tm = build_detection_model(tcfg, device="cpu")
    tm.load_state_dict(params_from_jax(params), strict=True)
    params = jax.tree.map(jnp.asarray, params)
    infer = jax.jit(jm.infer_forward)
    return jm, params, tm, lambda b: infer(params, {k: jnp.asarray(v) for k, v in b.items()})


def _assert_same(got, want):
    assert got.size == want.size and len(got) == len(want)
    np.testing.assert_array_equal(got.get_field("labels"), want.get_field("labels"))
    np.testing.assert_allclose(got.get_field("scores"), want.get_field("scores"),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.bbox, want.bbox, rtol=0, atol=1e-3)


def test_im_detect_bbox_matches_jax(pair):
    jm, params, tm, device_infer = pair
    jcfg, tcfg = _eval_configs()
    rs = np.random.RandomState(3)
    rgb = [(rs.rand(120, 160, 3) * 255).astype(np.uint8) for _ in range(2)]
    for hflip in (False, True):
        want = jax_bbox_aug.im_detect_bbox(jm, params, [PIL.fromarray(im) for im in rgb], 120,
                                           160, device_infer, jcfg, hflip=hflip)
        got = bbox_aug.im_detect_bbox(tm, rgb, 120, 160, tcfg, hflip=hflip)
        assert sum(len(g) for g in got) >= 10
        for g, w in zip(got, want):
            _assert_same(g, w)
    # the whole augmentation of one image: four passes, merged
    want = jax_bbox_aug.im_detect_bbox_aug(jm, params, [PIL.fromarray(rgb[0])], device_infer,
                                           jcfg)
    got = bbox_aug.im_detect_bbox_aug(tm, rgb[:1], tcfg)
    _assert_same(got[0], want[0])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tta")
    root = tmp / "datasets"
    img_dir, ann_file = make_synthetic_coco(str(tmp / "gen"), num_images=5, num_classes=3,
                                            seed=4)
    (root / "coco" / "annotations").mkdir(parents=True)
    shutil.move(img_dir, str(root / "coco" / "val2017"))
    shutil.copy(ann_file, str(root / "coco" / "annotations" / "instances_val2017.json"))
    return root


def test_inference_with_tta_matches_jax(pair, tree, tmp_path, monkeypatch):
    monkeypatch.setattr(JaxCatalog, "DATA_DIR", str(tree))
    monkeypatch.setenv("MASKRCNN_TPU_DATA_DIR", str(tree))
    jm, params, tm, _ = pair
    jcfg, tcfg = _eval_configs()
    (jloader,) = jax_make_data_loader(jcfg, is_train=False)
    (tloader,) = make_data_loader(tcfg, is_train=False)
    kw = dict(dataset_name="coco_2017_val", iou_types=("bbox",))
    want, _ = jax_inference(jm, params, jloader, output_folder=str(tmp_path / "jax"),
                            bbox_aug_cfg=jcfg, **kw)
    got, _ = inference(tm, tloader, output_folder=str(tmp_path / "torch"), bbox_aug_cfg=tcfg,
                       **kw)
    preds = []
    for side in ("jax", "torch"):
        with open(tmp_path / side / "predictions.pkl", "rb") as f:
            preds.append(pickle.load(f))
    assert len(preds[1]) == len(preds[0]) == 5
    assert sum(len(p) for p in preds[1]) >= 20
    for g, w in zip(preds[1], preds[0]):
        _assert_same(g, w)
        assert set(g.fields()) == {"scores", "labels"}
    for k, v in want.results["bbox"].items():
        assert abs(got.results["bbox"][k] - v) <= 1e-3, (k, got.results["bbox"][k], v)


def test_segm_and_keypoints_under_tta(pair, monkeypatch):
    """The JAX package's TTA on a mask model keeps each pass's mask
    probabilities as the model gave them: a flipped pass's are those of the
    flipped image, not flipped back, though its boxes are. Its merge cannot
    concatenate detection keypoints. The port refuses both iou types before
    running a pass."""
    jm, params, tm, device_infer = pair
    jcfg, tcfg = _eval_configs()
    rgb = (np.random.RandomState(5).rand(120, 160, 3) * 255).astype(np.uint8)
    (flipped,) = jax_bbox_aug.im_detect_bbox(jm, params, [PIL.fromarray(rgb)], 120, 160,
                                             device_infer, jcfg, hflip=True)
    padded, sizes = bbox_aug.pass_input(rgb, 120, 160, tcfg, hflip=True)
    det = jax.tree.map(np.asarray, device_infer({"images": padded, "image_sizes": sizes}))
    raw = det["masks"][0][det["valid"][0]]
    assert flipped.has_field("mask") and len(raw) >= 4
    np.testing.assert_array_equal(flipped.get_field("mask"), raw)  # not mirrored
    assert not np.allclose(raw, raw[..., ::-1], atol=1e-3)
    kps = [JaxBoxList(np.zeros((1, 4), np.float32), (160, 120)) for _ in range(2)]
    for bl in kps:
        bl.add_field("keypoints", JaxDetectionKeypoints(np.zeros((1, 17, 4)), (160, 120)))
    with pytest.raises(AttributeError):
        jax_cat_boxlist(kps)
    bl = JaxBoxList(np.zeros((1, 4), np.float32), (160, 120))
    bl.add_field("mask", raw[:1])
    np.testing.assert_array_equal(bl.transpose(JAX_FLIP).get_field("mask"), raw[:1])

    def no_pass(*args, **kwargs):
        raise AssertionError("a pass ran")

    monkeypatch.setattr(bbox_aug, "im_detect_bbox", no_pass)
    loader = [([rgb], [None], [0])]
    for iou_types in (("bbox", "segm"), ("bbox", "keypoints")):
        with pytest.raises(ValueError, match=iou_types[1]):
            inference(tm, loader, "x", iou_types=iou_types, bbox_aug_cfg=tcfg)
