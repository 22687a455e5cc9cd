"""The port's Keypoint R-CNN against the JAX package's, on the CPU in float32.

configs/e2e_keypoint_rcnn_R_50_FPN_1x.yaml at the narrow widths of
torch_port_fixtures (keypoint convs 8 x 32), the JAX parameter tree drawn
in numpy (torch_port_fixtures.numpy_tree) and handed over through
params_from_jax. Tolerances:

* the keypoint structures, the dataset's keypoint field and filter, the
  collator's gt_keypoints (through a horizontal flip): exact;
* heatmap targets (bins and validity, joints on the ROI's edge and out of
  it, at bin edges): exact; ``keypoint_head_loss`` rtol 1e-5;
* ``train_forward`` with JAX's sampler draws: every loss rtol 1e-5, every
  trainable gradient within 2e-4 of the JAX gradient's max (one gt without
  a visible joint in its box, so the box sampler's gt filter runs);
* ``infer_forward``: labels and validity exact, scores 1e-5, boxes 1e-3 px,
  kp_heatmaps 1e-5; the device decode (KEYPOINT_DECODE_ON_DEVICE) within
  1e-4 px of JAX's;
* the numpy bicubic (``resize_bicubic``) against cv2.resize(INTER_CUBIC)
  on spread float32 maps at 60 ROI sizes from 1x1 to 300x200 (the identity
  56 and sizes under 56 among them): values within 1e-6 of the map's
  largest magnitude, the maximum of each joint's map at the same pixel;
  ``resized_maxima`` equal to the whole map's argmax and value bit for bit;
* ``heatmaps_to_keypoints_exact`` against JAX's (which calls cv2): the same
  pixels, so the same coordinates, and values within 1e-6 relative;
* ``prepare_for_coco_keypoint`` equal to JAX's, and the keypoint AP (OKS)
  of a known answer and of shifted joints equal to JAX's evaluator's;
* the three keypoint YAMLs build and take the JAX tree strict=True; a
  Detectron keypoint .pkl loads bit for bit as JAX's loader loads it.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp

from chip_smoke import detectron_blobs, write_pkl
from maskrcnn_tpu.config import cfg as jax_defaults
from maskrcnn_tpu.data.collate import BatchCollator as JaxCollator
from maskrcnn_tpu.data.datasets import COCODataset as JaxCOCO
from maskrcnn_tpu.data.evaluation.coco_eval import do_coco_evaluation as jax_do_coco_evaluation
from maskrcnn_tpu.data.evaluation.coco_eval import (
    prepare_for_coco_keypoint as jax_prepare_for_coco_keypoint,
)
from maskrcnn_tpu.data.transforms import build_transforms as jax_build_transforms
from maskrcnn_tpu.engine.inference import DetectionKeypoints as JaxDetectionKeypoints
from maskrcnn_tpu.models import build_detection_model as build_jax_model
from maskrcnn_tpu.models.roi_heads import keypoint_head as jkh
from maskrcnn_tpu.structures import BoxList as JaxBoxList
from maskrcnn_tpu.structures import PersonKeypoints as JaxPersonKeypoints
from maskrcnn_tpu.utils import c2_loading as jax_c2
from maskrcnn_tpu_torch.config import cfg as torch_defaults
from maskrcnn_tpu_torch.data.collate import BatchCollator
from maskrcnn_tpu_torch.data.datasets import COCODataset
from maskrcnn_tpu_torch.data.evaluation.coco_eval import (
    do_coco_evaluation,
    prepare_for_coco_keypoint,
)
from maskrcnn_tpu_torch.data.transforms import build_transforms
from maskrcnn_tpu_torch.engine.inference import DetectionKeypoints, detections_to_boxlists
from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN
from maskrcnn_tpu_torch.models.roi_heads import keypoint_head as kh
from maskrcnn_tpu_torch.structures import FLIP_LEFT_RIGHT, BoxList, PersonKeypoints
from maskrcnn_tpu_torch.utils import c2_loading
from maskrcnn_tpu_torch.utils.convert import params_from_jax
from synthetic_coco import make_synthetic_coco
from test_models import tiny
from test_torch_weights import _assert_equal_to_jax, _identity_bn, _random_bn, _seeded_tree
from torch_port_fixtures import jax_sampler_draws, narrow, numpy_tree, train_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "e2e_keypoint_rcnn_R_50_FPN_1x.yaml")
YAMLS = ("e2e_keypoint_rcnn_R_50_FPN_1x.yaml",
         "caffe2/e2e_keypoint_rcnn_R_50_FPN_1x_caffe2.yaml",
         "quick_schedules/e2e_keypoint_rcnn_R_50_FPN_quick.yaml")
LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg", "loss_kp")
RNG = jax.random.PRNGKey(3)


def _configs(yaml=YAML):
    jcfg, tcfg = jax_defaults.clone(), torch_defaults.clone()
    for c in (jcfg, tcfg):
        c.merge_from_file(yaml)
        narrow(tiny(c))
        c.MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS = (32,) * 8
        c.MODEL.WEIGHT = ""
    return jcfg, tcfg


def keypoint_batch(seed=0):
    """torch_port_fixtures.train_batch's images and boxes as persons, with
    17 joints an instance: most inside its box (some visible, some not,
    invisible ones at (0, 0, 0) as COCO keeps them), one on the box's right
    edge, one outside it; image 0's gt 1 has every joint outside its box
    (the box sampler must ignore its matches)."""
    nb = train_batch(seed)
    del nb["gt_masks"]
    rs = np.random.RandomState(seed + 100)
    gt, valid = nb["gt_boxes"], nb["gt_labels"] > 0
    nb["gt_labels"] = valid.astype(np.int32)
    b, g = valid.shape
    x = rs.uniform(gt[..., 0:1], gt[..., 2:3], (b, g, 17))
    y = rs.uniform(gt[..., 1:2], gt[..., 3:4], (b, g, 17))
    v = rs.choice([0, 1, 2], (b, g, 17), p=[0.2, 0.3, 0.5]).astype(np.float32)
    x[..., 3] = gt[..., 2]
    v[..., 3] = 2
    x[..., 5] = gt[..., 2] + 7
    v[..., 5] = 2
    x[0, 1] = gt[0, 1, 2] + rs.uniform(2, 9, 17)
    v[0, 1] = 2
    kps = np.stack([x, y, v], -1).astype(np.float32)
    kps[kps[..., 2] == 0] = 0
    kps[~valid] = 0
    nb["gt_keypoints"] = kps
    return nb


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _configs()
    jm = build_jax_model(jcfg)
    tree = numpy_tree(jm)
    pred = tree["roi_heads"]["box"]["predictor"]
    rs = np.random.RandomState(1)
    pred["cls_score"]["w"] = rs.normal(0, 0.3, pred["cls_score"]["w"].shape).astype(np.float32)
    pred["bbox_pred"]["w"] = rs.normal(0, 0.02, pred["bbox_pred"]["w"].shape).astype(np.float32)
    tm = GeneralizedRCNN(tcfg)
    tm.load_state_dict(params_from_jax(tree), strict=True)
    nb = keypoint_batch()
    n_props = tcfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN + nb["gt_boxes"].shape[1]
    # anchors of a 128 x 160 batch: (32*40 + 16*20 + 8*10 + 4*5 + 2*3) * 3
    draws = jax_sampler_draws(RNG, nb["images"].shape[0], 5118, n_props)
    return dict(jcfg=jcfg, tcfg=tcfg, jm=jm, params=jax.tree.map(jnp.asarray, tree), tree=tree,
                tm=tm.eval(), batch=nb, draws=draws)


# -- structures and targets ---------------------------------------------------------


def test_person_keypoints_equal_jax():
    assert PersonKeypoints.NAMES == JaxPersonKeypoints.NAMES
    assert PersonKeypoints.FLIP_MAP == JaxPersonKeypoints.FLIP_MAP
    np.testing.assert_array_equal(PersonKeypoints.FLIP_INDS, JaxPersonKeypoints.FLIP_INDS)
    assert PersonKeypoints.CONNECTIONS == JaxPersonKeypoints.CONNECTIONS
    kps = keypoint_batch()["gt_keypoints"][0]
    got, want = PersonKeypoints(kps, (160, 128)), JaxPersonKeypoints(kps, (160, 128))
    for g, w in ((got.resize((200, 96)), want.resize((200, 96))),
                 (got.transpose(FLIP_LEFT_RIGHT), want.transpose(FLIP_LEFT_RIGHT)),
                 (got[np.array([2, 0])], want[np.array([2, 0])])):
        assert g.size == w.size and type(g) is PersonKeypoints
        np.testing.assert_array_equal(g.to_array(), w.to_array())
    # the keypoints follow a BoxList through resize and flip, as the masks do
    bl = BoxList(keypoint_batch()["gt_boxes"][0], (160, 128))
    bl.add_field("keypoints", got)
    flipped = bl.resize((320, 256)).transpose(FLIP_LEFT_RIGHT).get_field("keypoints")
    np.testing.assert_array_equal(flipped.to_array(),
                                  want.resize((320, 256)).transpose(FLIP_LEFT_RIGHT).to_array())


def test_heatmap_targets_equal_jax():
    rs = np.random.RandomState(0)
    r = 64
    x1, y1 = rs.uniform(0, 300, (2, r, 1)).astype(np.float32)
    w, h = rs.uniform(0.5, 200, (2, r, 1)).astype(np.float32)
    rois = np.concatenate([x1, y1, x1 + w, y1 + h], 1)
    # joints inside, outside, on the right and bottom edges, and at bin edges
    fx, fy = rs.uniform(-0.2, 1.2, (2, r, 17))
    x = x1 + fx * w
    y = y1 + fy * h
    x[:, 0], y[:, 1] = rois[:, 2], rois[:, 3]
    edges = rs.randint(0, 57, (r, 4))
    x[:, 2:6] = x1 + np.float32(edges / 56) * w
    y[:, 6:10] = y1 + np.float32(edges / 56) * h
    v = rs.choice([0, 1, 2], (r, 17)).astype(np.float32)
    kps = np.stack([x, y, v], -1).astype(np.float32)
    want_lin, want_valid = jax.jit(jkh.keypoints_to_heatmap, static_argnums=2)(
        jnp.asarray(kps), jnp.asarray(rois), 56)
    lin, valid = kh.keypoints_to_heatmap(torch.from_numpy(kps), torch.from_numpy(rois), 56)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_array_equal(lin.numpy(), np.asarray(want_lin))
    assert 0.2 < valid.float().mean() < 0.8 and (lin.numpy() == 56 * 56 - 1).any()

    logits = rs.normal(0, 2, (r, 56, 56, 17)).astype(np.float32)
    roi_valid = rs.rand(r) > 0.2
    want = jkh.keypoint_head_loss(jnp.asarray(logits), jnp.asarray(kps), jnp.asarray(rois),
                                  jnp.asarray(roi_valid))
    got = kh.keypoint_head_loss(torch.from_numpy(logits).permute(0, 3, 1, 2),
                                torch.from_numpy(kps), torch.from_numpy(rois),
                                torch.from_numpy(roi_valid))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    want = jkh.keypoints_within_box_filter(jnp.asarray(kps[None]), jnp.asarray(rois[None]))
    got = kh.keypoints_within_box_filter(torch.from_numpy(kps[None]), torch.from_numpy(rois[None]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_upsample_and_device_decode_equal_jax():
    """The predictor's 2x upsample equals the JAX head's shift-adds, and
    F.interpolate's bilinear (align_corners=False) equals jax.image.resize
    at the edges of the map (its clamped border samples) and inside."""
    rs = np.random.RandomState(1)
    x = rs.normal(0, 1, (3, 28, 28, 17)).astype(np.float32)
    want = np.asarray(jkh._upsample2x_bilinear(jnp.asarray(x)))
    got = kh.upsample2x_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    maps = rs.normal(0, 1, (3, 56, 56, 17)).astype(np.float32)
    want_up = np.asarray(jax.image.resize(jnp.asarray(maps), (3, 224, 224, 17), "bilinear"))
    got_up = torch.nn.functional.interpolate(
        torch.from_numpy(maps).permute(0, 3, 1, 2), size=(224, 224), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1).numpy()
    for edge in (np.s_[:, :2], np.s_[:, -2:], np.s_[:, :, :2], np.s_[:, :, -2:]):
        np.testing.assert_allclose(got_up[edge], want_up[edge], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_up, want_up, rtol=0, atol=1e-5)
    # the decode on maps whose maxima have no near-equal rival (on noise,
    # XLA's resize, a dense contraction, rounds a near tie the other way)
    maps = _spread_maps(rs, 3)
    rois = np.array([[10, 20, 90, 200], [0, 0, 0.5, 0.5], [5.5, 7.25, 300, 31]], np.float32)
    want = np.asarray(jkh.heatmaps_to_keypoints(jnp.asarray(maps), jnp.asarray(rois)))
    got = kh.heatmaps_to_keypoints(torch.from_numpy(maps).permute(0, 3, 1, 2),
                                   torch.from_numpy(rois)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# -- the exact host decode -----------------------------------------------------------

SIZES = [(1, 1), (1, 7), (9, 1), (3, 2), (13, 20), (55, 56), (56, 56), (56, 55), (57, 56),
         (56, 112), (112, 56), (300, 200), (200, 300), (299, 1), (1, 200)]


def _spread_maps(rs, n=1):
    """Heatmap-like maps with one broad peak a joint and noise, plus
    plain noise: nowhere two equal values near a maximum."""
    yy, xx = np.mgrid[:56, :56]
    peaks = rs.uniform(0, 56, (n, 17, 2))
    maps = -((yy[None, :, :, None] - peaks[:, None, None, :, 1]) ** 2
             + (xx[None, :, :, None] - peaks[:, None, None, :, 0]) ** 2) / 40.0
    return (maps + rs.normal(0, 0.5, maps.shape)).astype(np.float32)


def test_numpy_bicubic_equals_cv2_inter_cubic():
    rs = np.random.RandomState(2)
    sizes = SIZES + [tuple(int(v) for v in rs.randint(1, [301, 201])) for _ in range(45)]
    assert len(sizes) == 60 and (56, 56) in sizes and min(w * h for w, h in sizes) == 1
    for k, (w, h) in enumerate(sizes):
        src = _spread_maps(rs)[0] if k % 2 else rs.normal(0, 3, (56, 56, 17)).astype(np.float32)
        want = cv2.resize(src, (w, h), interpolation=cv2.INTER_CUBIC).reshape(h, w, 17)
        got = kh.resize_bicubic(src, w, h)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max(),
                                   err_msg=str((w, h)))
        flat = got.reshape(-1, 17)
        pos = flat.argmax(0)
        np.testing.assert_array_equal(pos, want.reshape(-1, 17).argmax(0), err_msg=str((w, h)))
        got_pos, got_val = kh.resized_maxima(src, w, h)
        np.testing.assert_array_equal(got_pos, pos)
        np.testing.assert_array_equal(got_val, flat[pos, np.arange(17)])


@pytest.mark.parametrize("kind", ["spread", "noise", "ties"])
def test_resized_maxima_equal_the_whole_map_on_tall_rois(kind):
    """The blocks' bound leaves out no maximum: on maps the size of
    person boxes at 800x1333, on noise and on maps full of equal values
    (the first maximum in raster order)."""
    rs = np.random.RandomState(3)
    for w, h in ((700, 500), (113, 812), (1333, 800), (240, 131)):
        if kind == "spread":
            src = _spread_maps(rs)[0]
        elif kind == "noise":
            src = rs.normal(0, 1, (56, 56, 17)).astype(np.float32)
        else:
            src = np.round(rs.normal(0, 1, (56, 56, 17))).astype(np.float32)
        flat = kh.resize_bicubic(src, w, h).reshape(-1, 17)
        pos, val = kh.resized_maxima(src, w, h)
        np.testing.assert_array_equal(pos, flat.argmax(0))
        np.testing.assert_array_equal(val, flat.max(0))


def test_exact_decode_equals_jax():
    rs = np.random.RandomState(4)
    maps = _spread_maps(rs, 24)
    x1, y1 = rs.uniform(0, 200, (2, 24))
    w = np.r_[0.3, 1.0, 55.5, 56.0, rs.uniform(1, 400, 20)]
    h = np.r_[2.7, 0.9, 56.0, 120.25, rs.uniform(1, 300, 20)]
    rois = np.stack([x1, y1, x1 + w, y1 + h], 1).astype(np.float32)
    want = jkh.heatmaps_to_keypoints_exact(maps, rois)
    got = kh.heatmaps_to_keypoints_exact(maps, rois)
    np.testing.assert_array_equal(got[..., :3], want[..., :3])
    np.testing.assert_allclose(got[..., 3], want[..., 3], rtol=1e-6, atol=0)


# -- the model -----------------------------------------------------------------------


@pytest.mark.parametrize("cap", [32, 1])
def test_train_forward_losses_and_gradients_match_jax(setup, cap):
    """At the YAML's KEYPOINT_ROI_CAP (32 an image: every positive kept) and
    at 1 an image, where the batch-wide compaction keeps 2 of the 8 rows."""
    params, tm = setup["params"], setup["tm"]
    jcfg = setup["jcfg"].clone()
    jcfg.TPU.KEYPOINT_ROI_CAP = cap
    jm = build_jax_model(jcfg)
    tm.cfg.TPU.KEYPOINT_ROI_CAP = cap
    batch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    usable = np.asarray(jkh.keypoints_within_box_filter(batch["gt_keypoints"],
                                                        batch["gt_boxes"]))
    assert not usable[0, 1] and usable[setup["batch"]["gt_labels"] > 0].sum() > 4

    def loss_fn(p):
        losses = jm.train_forward(p, batch, RNG)
        return sum(jax.tree.leaves(losses)), losses

    (_, want_losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tm.zero_grad(set_to_none=True)
    try:
        losses = tm.train_forward({k: torch.from_numpy(v) for k, v in setup["batch"].items()},
                                  draws={k: torch.from_numpy(v)
                                         for k, v in setup["draws"].items()})
    finally:
        tm.cfg.TPU.KEYPOINT_ROI_CAP = setup["tcfg"].TPU.KEYPOINT_ROI_CAP
    assert tuple(losses) == LOSSES and set(want_losses) == set(LOSSES)
    for k in LOSSES:
        np.testing.assert_allclose(losses[k].item(), float(want_losses[k]), rtol=1e-5, err_msg=k)
    assert losses["loss_kp"] > 0
    sum(losses.values()).backward()
    want = params_from_jax(jax.tree.map(np.asarray, grads))
    trainable = 0
    for name, p in tm.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and name.startswith(("backbone.body.stem.",
                                                       "backbone.body.layer1.")), name
            continue
        trainable += 1
        scale = want[name].abs().max().item()
        err = (p.grad - want[name]).abs().max().item()
        if name.endswith("kps_score_lowres.bias"):
            # a spatial softmax's gradient sums to zero over its bins, so
            # the bias's is rounding on both sides: held to the weight's
            wscale = want[name.replace("bias", "weight")].abs().max().item()
            assert max(scale, p.grad.abs().max().item()) <= 1e-4 * wscale, (name, scale)
            continue
        assert scale > 0 or "keypoint" not in name, name
        assert err <= 2e-4 * scale, (name, err, scale)
    # layer2-4's convs and shortcuts, 8 FPN tensors, 6 of the RPN head, fc6,
    # fc7 and the box predictor with biases, the keypoint head's 9 convs
    assert trainable == 3 * 13 + 3 + 16 + 6 + 8 + 18


def test_infer_forward_matches_jax(setup):
    jm, params, tm = setup["jm"], setup["params"], setup["tm"]
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (2, 128, 160, 3)).astype(np.uint8)
    sizes = np.array([[128, 160], [112, 136]], np.int32)
    want = jax.jit(jm.infer_forward)(params, {"images": jnp.asarray(images),
                                              "image_sizes": jnp.asarray(sizes)})
    batch = {"images": torch.from_numpy(images), "image_sizes": torch.from_numpy(sizes)}
    got = tm.infer_forward(batch)
    assert set(got) == set(want) == {"boxes", "scores", "labels", "valid", "kp_heatmaps"}
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert want["valid"].sum() >= 8 and got["kp_heatmaps"].shape == (2, 8, 56, 56, 17)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["kp_heatmaps"], want["kp_heatmaps"], rtol=0,
                               atol=1e-5 * np.abs(want["kp_heatmaps"]).max())

    # the device decode under TPU.KEYPOINT_DECODE_ON_DEVICE against JAX's
    tm.cfg.TPU.KEYPOINT_DECODE_ON_DEVICE = True
    try:
        dev = tm.infer_forward(batch)
    finally:
        tm.cfg.TPU.KEYPOINT_DECODE_ON_DEVICE = False
    assert set(dev) == {"boxes", "scores", "labels", "valid", "keypoints"}
    flat = want["kp_heatmaps"].reshape(16, 56, 56, 17)
    want_kps = np.asarray(jax.jit(jkh.heatmaps_to_keypoints)(
        jnp.asarray(flat), jnp.asarray(want["boxes"].reshape(16, 4)))).reshape(2, 8, 17, 4)
    np.testing.assert_allclose(dev["keypoints"].numpy(), want_kps, rtol=0, atol=1e-4)

    # the host decode through detections_to_boxlists, as engine/inference.py
    # runs it, against JAX's
    from maskrcnn_tpu.engine.inference import detections_to_boxlists as jax_to_boxlists

    boxlists = detections_to_boxlists(want, sizes)
    for bl, jbl in zip(boxlists, jax_to_boxlists(want, sizes)):
        got_kps, want_kps = bl.get_field("keypoints"), jbl.get_field("keypoints")
        assert isinstance(got_kps, DetectionKeypoints)
        np.testing.assert_array_equal(got_kps.data[..., :3], want_kps.data[..., :3])
        resized = bl.resize((320, 256)).get_field("keypoints").data
        np.testing.assert_array_equal(resized[..., :2],
                                      jbl.resize((320, 256)).get_field("keypoints").data[..., :2])


@pytest.mark.parametrize("yaml", YAMLS)
def test_every_keypoint_config_builds_and_loads_the_jax_tree(yaml):
    jcfg, tcfg = _configs(os.path.join(REPO, "configs", yaml))
    assert tcfg.MODEL.KEYPOINT_ON and not tcfg.MODEL.MASK_ON
    assert tcfg.MODEL.ROI_KEYPOINT_HEAD.RESOLUTION == 56
    tm = GeneralizedRCNN(tcfg)
    tm.load_state_dict(params_from_jax(numpy_tree(build_jax_model(jcfg))), strict=True)
    names = [k for k in tm.state_dict() if k.startswith("roi_heads.keypoint.")]
    assert "roi_heads.keypoint.feature_extractor.conv_fcn8.weight" in names
    assert "roi_heads.keypoint.predictor.kps_score_lowres.weight" in names and len(names) == 18


def test_detectron_keypoint_pkl_equals_jax(tmp_path, caplog):
    import logging

    jcfg, tcfg = _configs()
    jm = build_jax_model(jcfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    template = _seeded_tree(shapes, np.random.RandomState(100), _identity_bn)
    state = {k: v.numpy() for k, v in params_from_jax(
        _seeded_tree(shapes, np.random.RandomState(5), _random_bn)).items()}
    blobs = detectron_blobs(np, state)
    assert "conv_fcn8_w" in blobs and "kps_score_lowres_b" in blobs
    path = str(tmp_path / "model_final.pkl")
    write_pkl(path, blobs, wrap=True)
    with caplog.at_level(logging.INFO):
        want = jax_c2.load_c2_weights(path, jcfg, template)
    model = GeneralizedRCNN(tcfg)
    model.load_state_dict(params_from_jax(template), strict=True)
    loaded = c2_loading.load_c2_weights(path, tcfg, model.state_dict())
    _assert_equal_to_jax(model, loaded, want, caplog)
    for k in ("roi_heads.keypoint.feature_extractor.conv_fcn3.weight",
              "roi_heads.keypoint.predictor.kps_score_lowres.weight"):
        assert torch.equal(loaded[k], torch.from_numpy(state[k])), k


# -- data and evaluation ---------------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """tests/synthetic_coco.py's tree with keypoints, its joints spread
    over each box (visibility 0, 1 or 2), and one image with under 10
    visible joints, which the training filter drops."""
    root = tmp_path_factory.mktemp("kp")
    img_dir, ann_file = make_synthetic_coco(str(root / "gen"), num_images=6, num_classes=1,
                                            seed=5, keypoints=True, n_obj_range=(2, 4))
    with open(ann_file) as f:
        data = json.load(f)
    rs = np.random.RandomState(6)
    for a in data["annotations"]:
        x0, y0, w, h = a["bbox"]
        xy = rs.uniform([x0, y0], [x0 + w, y0 + h], (17, 2))
        v = rs.choice([0, 1, 2], 17, p=[0.2, 0.3, 0.5])
        if a["image_id"] == 3:
            v = np.where(np.arange(17) < 2, 2, 0)
        kps = np.concatenate([np.round(xy, 2), v[:, None]], 1)
        kps[v == 0] = 0
        a["keypoints"] = kps.ravel().tolist()
        a["num_keypoints"] = int((v > 0).sum())
    (root / "coco" / "annotations").mkdir(parents=True)
    for name in ("minival2014", "valminusminival2014", "train2014"):
        with open(root / "coco" / "annotations" / "person_keypoints_{}.json".format(name),
                  "w") as f:
            json.dump(data, f)
    shutil.copytree(img_dir, str(root / "coco" / "train2014"))
    shutil.move(img_dir, str(root / "coco" / "val2014"))
    return root


def _datasets(tree, transforms=None):
    ann = str(tree / "coco" / "annotations" / "person_keypoints_minival2014.json")
    img = str(tree / "coco" / "val2014")
    jt, tt = transforms or (None, None)
    return (JaxCOCO(ann, img, remove_images_without_annotations=True, transforms=jt),
            COCODataset(ann, img, remove_images_without_annotations=True, transforms=tt))


def test_dataset_and_collator_keypoints_equal_jax(tree):
    jcfg, tcfg = _configs()
    for c in (jcfg, tcfg):
        c.INPUT.MIN_SIZE_TRAIN = (96,)
        c.INPUT.MAX_SIZE_TRAIN = 200
        c.INPUT.HORIZONTAL_FLIP_PROB_TRAIN = 1.0
    jds, tds = _datasets(tree)
    assert jds.ids == tds.ids and 3 not in tds.ids and len(tds) == 5
    for i in range(len(tds)):
        want, got = jds.get_target(i).get_field("keypoints"), tds.get_target(i).get_field("keypoints")
        assert type(got) is PersonKeypoints
        np.testing.assert_array_equal(got.to_array(), want.to_array())
    jds, tds = _datasets(tree, (jax_build_transforms(jcfg, True), build_transforms(tcfg, True)))
    items = [tds[i] for i in range(4)]
    jitems = [jds[i] for i in range(4)]
    got = BatchCollator(tcfg, is_train=True)(items)
    want = JaxCollator(jcfg, is_train=True)(jitems)
    assert got["gt_keypoints"].shape == (4, 8, 17, 3) and got["gt_keypoints"].dtype == np.float32
    np.testing.assert_allclose(got["gt_keypoints"], want["gt_keypoints"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["gt_boxes"], want["gt_boxes"], rtol=0, atol=1e-4)
    # flipped: the right joints' x is the left joints' mirrored
    t = tds.get_target(0)
    raw = t.resize(items[0][1].size).get_field("keypoints").to_array()
    width = items[0][1].size[0]
    flipped = got["gt_keypoints"][0, :len(t)]
    vis = raw[:, PersonKeypoints.FLIP_INDS, 2] > 0
    np.testing.assert_allclose(flipped[..., 0][vis],
                               (width - raw[:, PersonKeypoints.FLIP_INDS, 0] - 1)[vis], atol=1e-4)


def _predictions(ds, jax_side, shift=0.0, seed=7):
    """The gt of every image as detections (boxes, joints at visibility 2),
    joints shifted by up to `shift` px, as each package's BoxLists."""
    rs = np.random.RandomState(seed)
    box_cls = JaxBoxList if jax_side else BoxList
    kp_cls = JaxDetectionKeypoints if jax_side else DetectionKeypoints
    out = []
    for i in range(len(ds)):
        info = ds.get_img_info(i)
        anns = [a for a in ds.anns_by_img[ds.ids[i]] if not a.get("iscrowd", 0)]
        size = (info["width"], info["height"])
        bl = box_cls(np.asarray([a["bbox"] for a in anns], np.float32), size, "xywh")
        bl = bl.convert("xyxy")
        kps = np.asarray([a["keypoints"] for a in anns], np.float32).reshape(-1, 17, 3)
        kps = kps + np.concatenate([rs.uniform(-shift, shift, kps.shape[:2] + (2,)),
                                    np.zeros(kps.shape[:2] + (1,))], -1).astype(np.float32)
        det = np.concatenate([kps[..., :2], np.ones(kps.shape[:2] + (2,), np.float32)], -1)
        bl.add_field("scores", np.linspace(0.9, 0.5, len(anns)).astype(np.float32))
        bl.add_field("labels", np.ones(len(anns), np.int64))
        bl.add_field("keypoints", kp_cls(det, size))
        out.append(bl)
    return out


@pytest.mark.parametrize("shift", [0.0, 6.0])
def test_keypoint_evaluation_equals_jax(tree, shift):
    jds, tds = _datasets(tree)
    jpreds, tpreds = _predictions(jds, True, shift), _predictions(tds, False, shift)
    got = prepare_for_coco_keypoint(tpreds, tds)
    assert got == jax_prepare_for_coco_keypoint(jpreds, jds)
    assert sum(len(v) for v in got.values()) == sum(len(p) for p in tpreds) > 8
    res, _ = do_coco_evaluation(tds, tpreds, False, None, ("bbox", "keypoints"), (), 4)
    jres, _ = jax_do_coco_evaluation(jds, jpreds, False, None, ("bbox", "keypoints"), (), 4)
    assert res.results == jres.results
    if shift == 0:
        assert res.results["keypoints"]["AP50"] == res.results["keypoints"]["AP"] == 1.0
    else:
        assert 0 < res.results["keypoints"]["AP"] < 0.99


OPTS = [
    "MODEL.DEVICE", "cpu", "MODEL.WEIGHT", "", "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
    "MODEL.RESNETS.STEM_OUT_CHANNELS", "16", "MODEL.RESNETS.WIDTH_PER_GROUP", "16",
    "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", "32", "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64",
    "MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS", "(32, 32, 32, 32, 32, 32, 32, 32)",
    "TPU.COMPUTE_DTYPE", "float32", "INPUT.PIXEL_STD", "[57.375, 57.12, 58.395]",
    "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", "200", "MODEL.RPN.POST_NMS_TOP_N_TRAIN", "100",
    "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", "128", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "64",
    "MODEL.ROI_HEADS.SCORE_THRESH", "0.0", "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", "10",
    "INPUT.MIN_SIZE_TRAIN", "(120,)", "INPUT.MAX_SIZE_TRAIN", "160",
    "INPUT.MIN_SIZE_TEST", "120", "INPUT.MAX_SIZE_TEST", "160",
    "SOLVER.IMS_PER_BATCH", "2", "SOLVER.BASE_LR", "0.0001", "TEST.IMS_PER_BATCH", "2",
    "TPU.MAX_GT_BOXES", "8", "DATALOADER.NUM_WORKERS", "0", "SOLVER.CHECKPOINT_PERIOD", "2",
]


def test_train_net_and_test_net_run_a_keypoint_rcnn(tree, tmp_path, monkeypatch):
    """train_net with the keypoint YAML's datasets (keypoints_coco_2014_train
    and _valminusminival, concatenated) for 2 iterations at narrow widths,
    its final test on keypoints_coco_2014_minival (bbox and keypoints, the
    exact host decode), then test_net on the checkpoint."""
    from maskrcnn_tpu_torch.tools import test_net, train_net

    monkeypatch.setenv("MASKRCNN_TPU_DATA_DIR", str(tree))
    out = tmp_path / "out"
    model, meters = train_net.main(["--config-file", YAML] + OPTS + [
        "SOLVER.MAX_ITER", "2", "OUTPUT_DIR", str(out)])
    assert set(LOSSES) <= set(meters.meters)
    assert all(np.isfinite(meters.meters[k].global_avg) for k in LOSSES)
    ((res, _),) = test_net.main(["--config-file", YAML, "--ckpt", str(out / "model_final.pth")]
                                + OPTS + ["OUTPUT_DIR", str(tmp_path / "test")])
    assert set(res.results) == {"bbox", "keypoints"}
    assert all(-1 <= v <= 1 for v in res.results["keypoints"].values())
    with open(tmp_path / "test" / "inference" / "keypoints_coco_2014_minival" / "predictions.pkl",
              "rb") as f:
        import pickle

        preds = pickle.load(f)
    kps = np.asarray(preds[0].get_field("keypoints"))
    assert kps.shape == (len(preds[0]), 17, 4) and len(preds[0]) > 0 and np.isfinite(kps).all()
    assert preds[0].size == (160, 120)


def test_predictor_returns_keypoints_on_the_original_image(setup):
    """Predictor.compute_prediction: the joints of engine/inference.py's
    BoxLists resized to the request's image (COCODemo's compute_prediction),
    with the exact host decode and with the device decode."""
    from maskrcnn_tpu_torch.predictor import Predictor

    tm = setup["tm"]
    pred = Predictor(setup["tcfg"], model=tm, device="cpu", min_image_size=120)
    image = np.random.RandomState(9).randint(0, 256, (150, 200, 3)).astype(np.uint8)
    out = pred.compute_prediction(image)
    n = len(out["scores"])
    assert n > 0 and out["keypoints"].shape == (n, 17, 4) and out["boxes"].shape == (n, 4)
    images, sizes = pred.preprocess(image)
    det = tm.infer_forward({"images": images, "image_sizes": sizes})
    (bl,) = detections_to_boxlists({k: v for k, v in det.items()}, sizes.numpy())
    want = bl.resize((200, 150))
    np.testing.assert_allclose(out["boxes"], want.bbox, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(out["keypoints"], want.get_field("keypoints").data, rtol=1e-6,
                               atol=1e-4)
    tm.cfg.TPU.KEYPOINT_DECODE_ON_DEVICE = True
    try:
        dev = pred.compute_prediction(image)["keypoints"]
    finally:
        tm.cfg.TPU.KEYPOINT_DECODE_ON_DEVICE = False
    assert dev.shape == (n, 17, 4)
    # both decodes find each joint's peak within a few pixels of the image
    assert np.median(np.abs(dev[..., :2] - out["keypoints"][..., :2])) < 3
