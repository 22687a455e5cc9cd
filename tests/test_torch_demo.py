"""The port's demo (maskrcnn_tpu_torch/demo) against the JAX package's
demo/predictor.py, on the CPU.

* ``compute_prediction``: the same weights, an image already at
  ``min_image_size`` (neither package resizes it): labels exact, scores
  1e-5, boxes 1e-3 px; pasted masks on 99.5% of pixels at threshold 0.5
  (cv2's and torch's bilinear arithmetic differ where a probability sits at
  the threshold) and within one grey level in the heatmap mode.
* ``select_top_predictions`` exactly, ties included.
* The boxes, the mask overlay and the heatmap montage equal to the JAX
  demo's pixel for pixel (OpenCV is used here, by the JAX demo and for the
  primitives' own checks, never by the port).
* The label text and the keypoint skeleton are the port's own font and
  solid strokes: every pixel outside the label boxes and the strokes,
  dilated by 2 px, is equal; the label boxes share their left edge and
  bottom with the JAX demo's.
* The webcam loop over three synthetic frames, and its early stop.
"""

import importlib.util
import os

import numpy as np
import pytest

import jax

from maskrcnn_tpu.engine.inference import DetectionKeypoints as JaxDetectionKeypoints
from maskrcnn_tpu.structures.boxlist import BoxList as JaxBoxList
from maskrcnn_tpu_torch.demo import COCODemo, draw, webcam
from maskrcnn_tpu_torch.demo.predictor import draw_person_skeleton
from maskrcnn_tpu_torch.engine.inference import DetectionKeypoints
from maskrcnn_tpu_torch.structures import BoxList
from torch_port_fixtures import configs, model_pair, random_boxes

cv2 = pytest.importorskip("cv2")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_demo_module():
    spec = importlib.util.spec_from_file_location(
        "jax_demo_predictor", os.path.join(REPO, "demo", "predictor.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_DEMO = _jax_demo_module()


@pytest.fixture(scope="module")
def pair():
    return model_pair()


def _demos(pair, show_mask_heatmaps=False, confidence_threshold=0.0):
    jm, params, tm = pair
    jcfg, tcfg = configs()
    jcfg.MODEL.WEIGHT = ""
    jd = object.__new__(JAX_DEMO.COCODemo)  # its model and params without its init
    jd.cfg, jd.model, jd.params, jd.min_image_size = jcfg, jm, params, 120
    jd.masker = JAX_DEMO.Masker(threshold=-1 if show_mask_heatmaps else 0.5, padding=1)
    jd.confidence_threshold, jd.show_mask_heatmaps, jd.masks_per_dim = \
        confidence_threshold, show_mask_heatmaps, 2
    jd._infer = jax.jit(jm.infer_forward)
    jd.to_bgr255 = jcfg.INPUT.TO_BGR255
    jd.pixel_mean = np.asarray(jcfg.INPUT.PIXEL_MEAN, np.float32)
    jd.pixel_std = np.asarray(jcfg.INPUT.PIXEL_STD, np.float32)
    td = COCODemo(tcfg, confidence_threshold=confidence_threshold,
                  show_mask_heatmaps=show_mask_heatmaps, min_image_size=120, model=tm)
    return jd, td


@pytest.mark.parametrize("heatmaps", [False, True])
def test_compute_prediction_matches_jax(pair, heatmaps):
    jd, td = _demos(pair, heatmaps)
    bgr = np.random.RandomState(1).randint(0, 256, (120, 150, 3)).astype(np.uint8)
    want, got = jd.compute_prediction(bgr), td.compute_prediction(bgr)
    assert got.size == want.size == (150, 120) and len(got) == len(want) >= 4
    np.testing.assert_array_equal(got.get_field("labels"), want.get_field("labels"))
    np.testing.assert_allclose(got.get_field("scores"), want.get_field("scores"),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.bbox, want.bbox, rtol=0, atol=1e-3)
    gm, wm = got.get_field("mask"), want.get_field("mask")
    assert gm.shape == wm.shape == (len(want), 120, 150) and gm.dtype == wm.dtype == np.uint8
    if heatmaps:
        assert gm.max() > 1 and np.abs(gm.astype(int) - wm).max() <= 1
    else:
        assert gm.max() == 1 and (gm == wm).mean() >= 0.995


def _predictions(rs, n, h, w, heatmaps=False):
    """The same detections as a JAX and a port BoxList: boxes partly
    outside the image, scores with ties, masks (binary, or 0-255)."""
    boxes = random_boxes(rs, n, -10, max(h, w) + 10, 6, 90)
    scores = np.round(rs.uniform(0.3, 1.0, n), 1).astype(np.float32)
    labels = rs.randint(1, 81, n)
    yy, xx = np.mgrid[:h, :w]
    masks = np.zeros((n, h, w), np.uint8)
    for i, (x0, y0, x1, y1) in enumerate(boxes):
        cx, cy, r = (x0 + x1) / 2, (y0 + y1) / 2, max(x1 - x0, 4) / 3
        masks[i] = (xx - cx) ** 2 + (yy - cy) ** 2 < r * r
        if heatmaps:
            masks[i] = (masks[i] * rs.randint(1, 256, (h, w))).astype(np.uint8)
    kps = np.zeros((n, 17, 4), np.float32)
    kps[..., 0] = rs.uniform(0, w, (n, 17))
    kps[..., 1] = rs.uniform(0, h, (n, 17))
    kps[..., 3] = rs.uniform(0, 6, (n, 17))
    out = []
    for cls, kcls in ((JaxBoxList, JaxDetectionKeypoints), (BoxList, DetectionKeypoints)):
        bl = cls(boxes.copy(), (w, h), mode="xyxy")
        bl.add_field("scores", scores.copy())
        bl.add_field("labels", labels.copy())
        bl.add_field("mask", masks.copy())
        bl.add_field("keypoints", kcls(kps.copy(), (w, h)))
        out.append(bl)
    return out


def test_select_top_predictions_matches_jax(pair):
    jd, td = _demos(pair, confidence_threshold=0.55)
    a, b = _predictions(np.random.RandomState(2), 30, 90, 120)
    want, got = jd.select_top_predictions(a), td.select_top_predictions(b)
    assert 0 < len(got) == len(want) < 30
    np.testing.assert_array_equal(got.bbox, want.bbox)
    np.testing.assert_array_equal(got.get_field("scores"), want.get_field("scores"))


@pytest.mark.parametrize("seed", [3, 4])
def test_boxes_mask_overlay_and_montage_equal_jax_pixel_for_pixel(pair, seed):
    rs = np.random.RandomState(seed)
    jd, td = _demos(pair)
    h, w = (97, 131) if seed == 3 else (120, 160)
    image = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    a, b = _predictions(rs, 12, h, w)
    np.testing.assert_array_equal(td.overlay_boxes(image.copy(), b),
                                  jd.overlay_boxes(image.copy(), a))
    np.testing.assert_array_equal(td.overlay_mask(image.copy(), b),
                                  jd.overlay_mask(image.copy(), a))
    a, b = _predictions(rs, 5, h, w, heatmaps=True)
    for d in (2, 3):
        jd.masks_per_dim = td.masks_per_dim = d
        got, want = td.create_mask_montage(image.copy(), b), jd.create_mask_montage(image.copy(), a)
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_drawing_primitives_match_cv2():
    rs = np.random.RandomState(5)
    k = np.ones((3, 3), np.uint8)
    for _ in range(40):
        h, w = rs.randint(4, 50, 2)
        img = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        p0, p1 = (tuple(int(v) for v in rs.randint(-10, 60, 2)) for _ in range(2))
        color = tuple(int(v) for v in rs.randint(0, 256, 3))
        for t in (1, -1):
            want = cv2.rectangle(img.copy(), p0, p1, color, t)
            np.testing.assert_array_equal(draw.rectangle(img.copy(), p0, p1, color, t), want)
        m = (rs.rand(h, w) < 0.5).astype(np.uint8)
        np.testing.assert_array_equal(draw.dilate(m, 2), cv2.dilate(m, k, iterations=2))
        np.testing.assert_array_equal(draw.erode(m, 1), cv2.erode(m, k, iterations=1))
        other = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        np.testing.assert_array_equal(draw.add_weighted(img, 0.3, other, 0.7),
                                      cv2.addWeighted(img, 0.3, other, 0.7, 0))
    gray = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(draw.apply_jet(gray), cv2.applyColorMap(gray, cv2.COLORMAP_JET))


def _dilated(mask, px=2):
    return cv2.dilate(mask.astype(np.uint8), np.ones((2 * px + 1, 2 * px + 1), np.uint8)) > 0


def test_text_and_skeleton_equal_outside_their_strokes(pair):
    rs = np.random.RandomState(6)
    jd, td = _demos(pair)
    h, w = 140, 180
    image = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    a, b = _predictions(rs, 6, h, w)
    got, want = td.overlay_class_names(image.copy(), b), jd.overlay_class_names(image.copy(), a)
    boxes = np.zeros((h, w), bool)
    ours = td.label_boxes(b)
    for (text, (x0, y0), (x1, y1)), box, score, label in zip(
            ours, np.asarray(a.bbox, np.int64), a.get_field("scores"), a.get_field("labels")):
        assert text == "{}: {:.2f}".format(JAX_DEMO.COCODemo.CATEGORIES[label], score)
        (tw, th), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        jy = max(box[1], th + base)  # the JAX demo's label box: (x, jy - th - base)-(x + tw, jy)
        assert x0 == box[0] and (y1 == jy or box[1] < max(th + base, y1 - y0))
        for (u0, v0, u1, v1) in ((x0, y0, x1, y1), (box[0], jy - th - base, box[0] + tw, jy)):
            boxes[max(v0, 0):max(v1 + 1, 0), max(u0, 0):max(u1 + 1, 0)] = True
    assert boxes.any() and not boxes.all()
    outside = ~_dilated(boxes)
    np.testing.assert_array_equal(got[outside], want[outside])

    kp = np.asarray(b.get_field("keypoints"))
    for inst in kp:
        got = draw_person_skeleton(image, inst[:, :2], inst[:, 3], td.class_color)
        want = JAX_DEMO.draw_person_skeleton(image, inst[:, :2], inst[:, 3], jd.class_color)
        strokes = (got != image).any(-1) | (want != image).any(-1)
        assert strokes.any()
        outside = ~_dilated(strokes)
        np.testing.assert_array_equal(got[outside], want[outside])


def test_run_on_opencv_image_and_webcam_loop(pair):
    _, td = _demos(pair, confidence_threshold=0.0)
    rs = np.random.RandomState(7)
    frames = [rs.randint(0, 256, (120, 150, 3)).astype(np.uint8) for _ in range(3)]
    shown = []
    n = webcam.run(td, frames, lambda img, s: shown.append((img, s)))
    assert n == 3 and len(shown) == 3
    for (img, s), frame in zip(shown, frames):
        assert img.shape == frame.shape and img.dtype == np.uint8 and s >= 0
        assert (img != frame).any()
    assert webcam.run(td, frames, lambda img, s: True) == 1
    _, heat = _demos(pair, show_mask_heatmaps=True)
    montage = heat.run_on_opencv_image(frames[0])
    assert montage.shape == (120, 150, 3) and montage.dtype == np.uint8


def test_demo_defaults_to_the_card():
    """COCODemo builds its model on MODEL.DEVICE, cuda by default: on a
    machine with no card that fails instead of running on the CPU."""
    import torch

    _, c = configs()
    c.MODEL.WEIGHT = ""
    assert c.MODEL.DEVICE == "cuda"
    if torch.cuda.is_available():
        assert next(COCODemo(c).model.parameters()).is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            COCODemo(c)
