"""The port's RPN-only models and ROIPool against the JAX package's, on the
CPU in float32:

* configs/rpn_R_50_FPN_1x.yaml and rpn_R_50_C4_1x.yaml at the narrow widths
  of torch_port_fixtures (C4: the body's C4 at 4 x 64 channels):
  train_forward returns the two RPN losses alone, equal to JAX's with every
  gradient on JAX's sampler draws, and no ROI head exists;
* the proposals as the detections (infer_forward): boxes, scores, labels
  1 and validity, in JAX's order;
* ``engine.inference.inference(box_only=True)`` over a synthetic COCO tree
  against JAX's: the same proposals on the original images and the same
  box-proposal recalls (AR, ARs, ARm, ARl at 100 and 1000);
* one ``Predictor`` request: the valid proposals on the original image;
* ``ops.roi_align.roi_pool`` (integer-rounded ROIs, bins over [floor, ceil),
  empty bins 0) forward and gradient against JAX's eager roi_pool, ties
  split as jnp.max splits them.

Tolerances: losses rtol 1e-5; every gradient within 2e-4 of the JAX
gradient's max; proposals: validity and labels exact, scores 1e-5, boxes
1e-3 px; recalls 1e-6; roi_pool exact forward, gradient 1e-6.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskrcnn_tpu.config import cfg as jax_defaults
from maskrcnn_tpu.config.paths_catalog import DatasetCatalog as JaxCatalog
from maskrcnn_tpu.data import make_data_loader as jax_make_data_loader
from maskrcnn_tpu.engine.inference import inference as jax_inference
from maskrcnn_tpu.models import build_detection_model as build_jax_model
from maskrcnn_tpu.ops.roi_align import roi_pool as jax_roi_pool
from maskrcnn_tpu_torch import Predictor
from maskrcnn_tpu_torch.config import cfg as torch_defaults
from maskrcnn_tpu_torch.data.build import make_data_loader
from maskrcnn_tpu_torch.engine.inference import inference
from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN
from maskrcnn_tpu_torch.ops.roi_align import roi_pool
from maskrcnn_tpu_torch.tools.test_net import box_only
from maskrcnn_tpu_torch.utils.convert import params_from_jax
from synthetic_coco import make_synthetic_coco
from test_models import tiny
from torch_port_fixtures import one_torch_thread  # noqa: F401
from torch_port_fixtures import _redraw, jax_sampler_draws, narrow, train_batch

pytestmark = pytest.mark.usefixtures("one_torch_thread")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = jax.random.PRNGKey(11)
HW = (128, 160)


def _configs(name):
    jcfg, tcfg = jax_defaults.clone(), torch_defaults.clone()
    for c in (jcfg, tcfg):
        c.merge_from_file(os.path.join(REPO, "configs", name))
        narrow(tiny(c))
        c.MODEL.WEIGHT = ""
        if "C4" in name:
            c.MODEL.RESNETS.BACKBONE_OUT_CHANNELS = c.MODEL.RESNETS.RES2_OUT_CHANNELS * 4
    return jcfg, tcfg


def _rpn_params(jm):
    """The JAX init with frozen BN redrawn (torch_port_fixtures._redraw) and
    the objectness weights 20x, so that the proposals' scores are well
    apart."""
    params = _redraw(jax.jit(jm.init)(jax.random.PRNGKey(0)), np.random.RandomState(0))
    params["rpn"]["cls_logits"]["w"] = params["rpn"]["cls_logits"]["w"] * 20
    return params


@pytest.fixture(scope="module", params=["rpn_R_50_FPN_1x.yaml", "rpn_R_50_C4_1x.yaml"])
def setup(request):
    jcfg, tcfg = _configs(request.param)
    assert tcfg.MODEL.RPN_ONLY and not tcfg.MODEL.RETINANET_ON and box_only(tcfg)
    jm = build_jax_model(jcfg)
    params = _rpn_params(jm)
    assert set(params) == {"backbone", "rpn"}
    tm = GeneralizedRCNN(tcfg)
    tm.load_state_dict(params_from_jax(params), strict=True)
    assert not hasattr(tm, "roi_heads")
    nb = train_batch(h=HW[0], w=HW[1])
    del nb["gt_masks"]
    if tcfg.MODEL.RPN.USE_FPN:
        n_anchors = 3 * sum(-(-HW[0] // s) * -(-HW[1] // s) for s in (4, 8, 16, 32, 64))
    else:
        n_anchors = 15 * (HW[0] // 16) * (HW[1] // 16)
    draws = jax_sampler_draws(RNG, 2, n_anchors, 1)
    draws = {k: v for k, v in draws.items() if k.startswith("rpn")}
    return dict(jm=jm, params=jax.tree.map(jnp.asarray, params), tm=tm.eval(), batch=nb,
                draws=draws, fpn=tcfg.MODEL.RPN.USE_FPN, tcfg=tcfg)


def test_rpn_only_losses_and_gradients_match_jax(setup):
    jm, params, tm = setup["jm"], setup["params"], setup["tm"]
    batch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}

    def loss_fn(p):
        losses = jm.train_forward(p, batch, RNG)
        return sum(jax.tree.leaves(losses)), losses

    (_, want_losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tm.zero_grad(set_to_none=True)
    # the RPN draws alone: the port asks for no box draws
    losses = tm.train_forward({k: torch.from_numpy(v) for k, v in setup["batch"].items()},
                              draws={k: torch.from_numpy(v) for k, v in setup["draws"].items()})
    names = ["loss_objectness", "loss_rpn_box_reg"]
    assert list(losses) == names and set(want_losses) == set(names)
    for k in names:
        np.testing.assert_allclose(losses[k].item(), float(want_losses[k]), rtol=1e-5, err_msg=k)
    assert losses["loss_rpn_box_reg"] > 0
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
        assert err <= 2e-4 * scale, (name, err, scale)
    assert trainable > 0


def _infer_pair(setup, images, sizes):
    want = jax.jit(setup["jm"].infer_forward)(setup["params"], {
        "images": jnp.asarray(images), "image_sizes": jnp.asarray(sizes)})
    got = setup["tm"].infer_forward({"images": torch.from_numpy(images),
                                     "image_sizes": torch.from_numpy(sizes)})
    return ({k: v.numpy() for k, v in got.items()}, {k: np.asarray(v) for k, v in want.items()})


def test_proposals_are_the_detections_as_in_jax(setup):
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (2,) + HW + (3,)).astype(np.uint8)
    sizes = np.array([list(HW), [112, 136]], np.int32)
    got, want = _infer_pair(setup, images, sizes)
    assert set(got) == set(want) == {"boxes", "scores", "labels", "valid"}
    tcfg = setup["tcfg"]
    k = tcfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST if setup["fpn"] else \
        tcfg.MODEL.RPN.POST_NMS_TOP_N_TEST
    assert got["boxes"].shape == want["boxes"].shape == (2, k, 4)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["valid"].sum() >= k  # most slots hold a proposal
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert got["labels"].dtype == np.int32 and (got["labels"] == 1).all()
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    # in objectness order within each image (the FPN top-k over the levels)
    if setup["fpn"]:
        v = got["scores"][0][got["valid"][0]]
        assert (np.diff(v) <= 0).all()


# -- through inference(box_only) and Predictor -----------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """coco_2017_val: 5 images of 120x160, 1-3 boxes each."""
    tmp = tmp_path_factory.mktemp("rpn_only")
    root = tmp / "datasets"
    img_dir, ann_file = make_synthetic_coco(str(tmp / "gen"), num_images=5, num_classes=3,
                                            seed=3)
    (root / "coco" / "annotations").mkdir(parents=True)
    shutil.move(img_dir, str(root / "coco" / "val2017"))
    shutil.copy(ann_file, str(root / "coco" / "annotations" / "instances_val2017.json"))
    return root


def test_inference_box_only_matches_jax(setup, tree, monkeypatch, tmp_path):
    """The normal entry point's evaluation of an RPN-only model: proposals
    resized to the original images, then their recall (JAX
    engine/inference.py with box_only, coco_eval.py:227-235)."""
    monkeypatch.setattr(JaxCatalog, "DATA_DIR", str(tree))
    monkeypatch.setenv("MASKRCNN_TPU_DATA_DIR", str(tree))
    jcfg, tcfg = _configs("rpn_R_50_FPN_1x.yaml" if setup["fpn"] else "rpn_R_50_C4_1x.yaml")
    for c in (jcfg, tcfg):
        c.DATASETS.TEST = ("coco_2017_val",)
        c.INPUT.MIN_SIZE_TEST, c.INPUT.MAX_SIZE_TEST = 120, 160
        c.TEST.IMS_PER_BATCH = 2
        c.DATALOADER.NUM_WORKERS = 0
        # past test_models.tiny's 32 proposals an image: some cover the gt
        c.MODEL.RPN.PRE_NMS_TOP_N_TEST, c.MODEL.RPN.POST_NMS_TOP_N_TEST = 600, 300
        c.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST = 300
    jm = build_jax_model(jcfg)
    tm = GeneralizedRCNN(tcfg).eval()
    tm.load_state_dict(setup["tm"].state_dict())
    (jloader,) = jax_make_data_loader(jcfg, is_train=False)
    (tloader,) = make_data_loader(tcfg, is_train=False)
    kw = dict(dataset_name="coco_2017_val", iou_types=("bbox",), box_only=True)
    want, _ = jax_inference(jm, jax.tree.map(np.asarray, setup["params"]), jloader, **kw)
    got, _ = inference(tm, tloader, output_folder=str(tmp_path), **kw)
    assert set(got.results) == {"box_proposal"}
    assert set(got.results["box_proposal"]) == set(want.results["box_proposal"]) == {
        "AR{}@{}".format(s, n) for n in (100, 1000) for s in ("", "s", "m", "l")}
    for k, v in want.results["box_proposal"].items():
        assert abs(got.results["box_proposal"][k] - v) <= 1e-6, (k, got.results, want.results)
    assert got.results["box_proposal"]["AR@1000"] > 0
    assert os.path.exists(tmp_path / "predictions.pkl")


def test_predictor_returns_the_proposals(setup):
    tm = setup["tm"]
    predictor = Predictor(setup["tcfg"], model=tm, device="cpu", min_image_size=HW[0])
    bgr = np.random.RandomState(4).randint(0, 256, (96, 120, 3)).astype(np.uint8)
    out = predictor.compute_prediction(bgr)
    assert set(out) == {"boxes", "scores", "labels"}
    images, sizes = predictor.preprocess(bgr)
    det = tm.infer_forward({"images": images, "image_sizes": sizes})
    valid = det["valid"][0]
    assert len(out["boxes"]) == int(valid.sum()) > 0
    assert (out["labels"] == 1).all()
    np.testing.assert_array_equal(out["scores"], det["scores"][0][valid].numpy())
    scale = np.array([120 / int(sizes[0, 1]), 96 / int(sizes[0, 0])] * 2, np.float32)
    np.testing.assert_allclose(out["boxes"], det["boxes"][0][valid].numpy() * scale, rtol=1e-6)


# -- ROIPool ---------------------------------------------------------------------------


@pytest.mark.parametrize("output_size,scale", [(7, 0.25), ((3, 5), 1 / 16)])
def test_roi_pool_matches_jax(output_size, scale):
    rs = np.random.RandomState(1)
    b, h, w, c, k = 2, 20, 24, 6, 9
    # values on a coarse grid: ties inside bins, split as jnp.max splits them
    feat = (np.round(rs.randn(b, h, w, c) * 2) / 2).astype(np.float32)
    ctr = rs.uniform(-10, 110 if scale == 0.25 else 400, (k, 2))
    wh = rs.uniform(1, 60 if scale == 0.25 else 250, (k, 2))
    rois = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)
    rois[0] = [-40, -40, -20, -20]  # off the map: every bin empty
    bidx = rs.randint(0, b, k).astype(np.int32)
    ph, pw = (output_size, output_size) if isinstance(output_size, int) else output_size
    cot = rs.randn(k, ph, pw, c).astype(np.float32)

    def jfn(f):
        y = jax_roi_pool(f, jnp.asarray(rois), jnp.asarray(bidx), output_size, scale)
        return (y * cot).sum(), y

    # eager: under jit XLA's arithmetic moves some bin edges (floor / ceil of
    # bin * size at whole numbers), so the jitted JAX roi_pool differs from
    # its own eager one in a few bins
    (_, want), jgrad = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(feat))
    tf = torch.from_numpy(feat).requires_grad_()
    got = roi_pool(tf, torch.from_numpy(rois), torch.from_numpy(bidx), output_size, scale)
    assert got.shape == (k, ph, pw, c)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert (got[0] == 0).all() and (got[1:] != 0).any()
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-6)
    assert (tf.grad != 0).sum() > k
