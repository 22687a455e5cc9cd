"""The port's serving path as a whole against the JAX package's.

* ``GeneralizedRCNN.infer_forward``: the JAX model and the port, the same
  parameters (params_from_jax) and the same uint8 batch, both float32 on the
  CPU. Labels and validity exact, scores 1e-5, boxes 1e-3 px, mask
  probabilities 1e-4.
* ``Predictor.compute_prediction`` with ``device="cpu"``: its preprocessing
  against the demo's cv2 resize (the short side to ``min_image_size``, 224
  by default, as COCODemo's), then the rest against the JAX pipeline the
  demo runs (infer_forward, detections_to_boxlists, BoxList.resize and the
  cv2 Masker) on the same preprocessed image. Pasted masks agree on at least
  99.5% of pixels: cv2's and torch's bilinear arithmetic differ where a
  probability sits at the 0.5 threshold.
"""

import importlib.util
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskrcnn_tpu.engine.inference import detections_to_boxlists
from maskrcnn_tpu.models.masker import Masker, expand_boxes as jax_expand_boxes
from maskrcnn_tpu_torch.models.masker import expand_boxes, paste_masks_in_image
from maskrcnn_tpu_torch.predictor import Predictor
from torch_port_fixtures import configs, model_pair, random_boxes

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def pair():
    return model_pair()


def _compare_detections(got, want):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["masks"], want["masks"], rtol=1e-4, atol=1e-4)


def test_infer_forward_matches_jax(pair):
    jm, params, tm = pair
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (2, 128, 160, 3)).astype(np.uint8)
    sizes = np.array([[128, 160], [112, 136]], np.int32)
    want = jax.jit(jm.infer_forward)(params, {"images": jnp.asarray(images),
                                              "image_sizes": jnp.asarray(sizes)})
    got = tm.infer_forward({"images": torch.from_numpy(images),
                            "image_sizes": torch.from_numpy(sizes)})
    assert set(got) == set(want) == {"boxes", "scores", "labels", "valid", "masks"}
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert got["masks"].shape == (2, 8, 28, 28)
    assert want["valid"].sum() >= 8
    _compare_detections(got, want)


def test_predictor_matches_demo_pipeline(pair):
    jm, params, tm = pair
    jcfg, tcfg = configs()
    for c in (jcfg, tcfg):
        c.INPUT.MAX_SIZE_TEST = 200
    pred = Predictor(tcfg, model=tm, device="cpu", min_image_size=120)
    bgr = np.random.RandomState(1).randint(0, 256, (150, 210, 3)).astype(np.uint8)

    images, sizes = pred.preprocess(bgr)
    nh, nw = (int(v) for v in sizes[0])
    assert (nh, nw) == (120, 168) and images.shape == (1, 128, 192, 3)
    resized = cv2.resize(bgr, (nw, nh), interpolation=cv2.INTER_LINEAR).astype(np.float32)
    mean, std = np.asarray(jcfg.INPUT.PIXEL_MEAN), np.asarray(jcfg.INPUT.PIXEL_STD)
    ours = images[0, :nh, :nw].numpy() * std + mean
    assert np.abs(ours - resized).max() <= 1.0 + 1e-3  # cv2 rounds in fixed point
    assert (images[0, nh:] == 0).all() and (images[0, :, nw:] == 0).all()

    out = pred.compute_prediction(bgr)
    det = jax.jit(jm.infer_forward)(params, {"images": jnp.asarray(images.numpy()),
                                             "image_sizes": jnp.asarray(sizes.numpy())})
    (want,) = detections_to_boxlists(jax.tree.map(np.asarray, det), sizes.numpy())
    want = want.resize((bgr.shape[1], bgr.shape[0]))
    pasted = Masker(threshold=0.5, padding=1)(want.get_field("mask"), want)

    np.testing.assert_array_equal(out["labels"], want.get_field("labels"))
    np.testing.assert_allclose(out["scores"], want.get_field("scores"), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out["boxes"], want.bbox, rtol=0, atol=1e-3)
    assert out["masks"].shape == pasted.shape == (len(want), 150, 210)
    assert out["masks"].dtype == np.uint8
    assert (out["masks"] == pasted).mean() >= 0.995


def _demo_preprocess(cfg, bgr, min_image_size):
    """COCODemo._preprocess (demo/predictor.py) without building its model."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "demo",
                        "predictor.py")
    spec = importlib.util.spec_from_file_location("demo_predictor", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    demo = types.SimpleNamespace(
        cfg=cfg, min_image_size=min_image_size, to_bgr255=cfg.INPUT.TO_BGR255,
        pixel_mean=np.asarray(cfg.INPUT.PIXEL_MEAN, np.float32),
        pixel_std=np.asarray(cfg.INPUT.PIXEL_STD, np.float32))
    return mod.COCODemo._preprocess(demo, bgr)


def test_predictor_resizes_by_min_image_size_as_coco_demo(pair):
    """At the default, the short side goes to COCODemo's min_image_size of
    224, not to INPUT.MIN_SIZE_TEST: a 480x640 image becomes 224x299, padded
    to the size divisibility."""
    _, _, tm = pair
    jcfg, tcfg = configs()
    assert tcfg.INPUT.MIN_SIZE_TEST != 224
    bgr = np.random.RandomState(2).randint(0, 256, (480, 640, 3)).astype(np.uint8)
    images, sizes = Predictor(tcfg, model=tm, device="cpu").preprocess(bgr)
    want, (nh, nw) = _demo_preprocess(jcfg, bgr, 224)
    assert (nh, nw) == (224, 299) and tuple(sizes[0].tolist()) == (nh, nw)
    assert tuple(images.shape) == want.shape
    std = np.asarray(jcfg.INPUT.PIXEL_STD)
    # in grey levels: cv2 rounds in fixed point
    assert np.abs((images.numpy() - want) * std).max() <= 1.0 + 1e-3


def test_masker_matches_cv2_paste():
    rs = np.random.RandomState(2)
    n, h, w = 12, 90, 130
    masks = rs.uniform(size=(n, 28, 28)).astype(np.float32)
    boxes = random_boxes(rs, n, -10, 140, 2, 90)
    boxes[0] = [30.4, 20.7, 29.9, 60.2]  # negative width after truncation
    np.testing.assert_allclose(expand_boxes(torch.from_numpy(boxes), 30 / 28).numpy(),
                               jax_expand_boxes(boxes, 30 / 28), rtol=1e-6, atol=1e-4)
    from maskrcnn_tpu.structures import BoxList

    want = Masker(threshold=0.5, padding=1)(masks, BoxList(boxes, (w, h), mode="xyxy"))
    got = paste_masks_in_image(torch.from_numpy(masks), torch.from_numpy(boxes), h, w).numpy()
    assert got.shape == want.shape
    assert (got == want).mean() >= 0.995
    assert got[0].sum() == want[0].sum() == 0 or (got[0] == want[0]).all()


def test_unported_model_families_raise():
    """No model family is left unported: RPN-only models build without ROI
    heads (tests/test_torch_rpn_only.py; FBNet and deformable convs:
    tests/test_torch_fbnet.py, tests/test_torch_dcn.py; RetinaNet and
    Keypoint R-CNN: tests/test_torch_retinanet.py, test_torch_keypoint.py).
    An RPN head that no config of the repository names still raises."""
    from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN

    _, c = configs()
    c.MODEL.RPN_ONLY = True
    model = GeneralizedRCNN(c)
    assert model.rpn_only and not hasattr(model, "roi_heads")
    _, c = configs()
    c.MODEL.RPN.RPN_HEAD = "SingleConvRPNHeadWithGN"
    with pytest.raises(NotImplementedError):
        GeneralizedRCNN(c)
    _, c = configs()
    c.MODEL.KEYPOINT_ON = True
    c.MODEL.ROI_KEYPOINT_HEAD.POOLER_SCALES = c.MODEL.ROI_BOX_HEAD.POOLER_SCALES
    c.MODEL.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO = 2
    assert GeneralizedRCNN(c).keypoint_on


def test_entry_points_default_to_the_card():
    """Without a device argument the model goes to cuda; on a machine with
    no card that fails instead of quietly running on the CPU."""
    from maskrcnn_tpu_torch.models import build_detection_model

    _, c = configs()
    if torch.cuda.is_available():
        assert next(build_detection_model(c).parameters()).is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            build_detection_model(c)
