"""COCODemo: one BGR image in, detections and a drawn image out.

Port of the JAX package's demo/predictor.py (after the reference
demo/predictor.py), the reference's public inference API:
``COCODemo(cfg, confidence_threshold=...).run_on_opencv_image(bgr_image)``.
The model runs on MODEL.DEVICE (the card unless the configuration asks for
"cpu") through ``maskrcnn_tpu_torch.Predictor``: the short side resized to
``min_image_size``, the detections brought back to the image and the masks
pasted there at 0.5, or as 0-255 probabilities with ``show_mask_heatmaps``
(the Masker's threshold -1).

The drawing is numpy (demo/draw.py), without OpenCV: the boxes, the mask
overlay and the heatmap montage are OpenCV's pixels; the label text and the
keypoint skeleton are drawn with this package's own small font and solid
strokes (same width and radius), where the JAX demo renders OpenCV's font
and anti-aliased strokes.
"""

import colorsys

import numpy as np

from ..engine.inference import DetectionKeypoints
from ..models.detector import build_detection_model
from ..predictor import Predictor
from ..structures import BoxList, PersonKeypoints
from ..utils.checkpoint import DetectronCheckpointer
from ..utils.miscellaneous import cfg_device
from . import draw


class COCODemo:
    CATEGORIES = [
        "__background", "person", "bicycle", "car", "motorcycle", "airplane",
        "bus", "train", "truck", "boat", "traffic light", "fire hydrant",
        "stop sign", "parking meter", "bench", "bird", "cat", "dog", "horse",
        "sheep", "cow", "elephant", "bear", "zebra", "giraffe", "backpack",
        "umbrella", "handbag", "tie", "suitcase", "frisbee", "skis",
        "snowboard", "sports ball", "kite", "baseball bat", "baseball glove",
        "skateboard", "surfboard", "tennis racket", "bottle", "wine glass",
        "cup", "fork", "knife", "spoon", "bowl", "banana", "apple",
        "sandwich", "orange", "broccoli", "carrot", "hot dog", "pizza",
        "donut", "cake", "chair", "couch", "potted plant", "bed",
        "dining table", "toilet", "tv", "laptop", "mouse", "remote",
        "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
        "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
        "hair drier", "toothbrush",
    ]

    def __init__(self, cfg, confidence_threshold=0.7, show_mask_heatmaps=False, masks_per_dim=2,
                 min_image_size=224, weight_loading=None, model=None):
        """As the JAX package's COCODemo; `model` (a model of `cfg`, already on
        its device, in place of building and loading one) is the port's
        own."""
        self.cfg = cfg.clone()
        self.min_image_size = min_image_size
        if model is None:
            model = build_detection_model(self.cfg, device=cfg_device(self.cfg))
            weight = weight_loading or cfg.MODEL.WEIGHT
            if weight:
                DetectronCheckpointer(self.cfg, model, save_dir=cfg.OUTPUT_DIR).load(weight)
        self.model = model
        # heatmap mode needs graded probabilities: threshold -1 pastes 0-255
        # probability maps instead of binary masks
        self.mask_threshold = -1 if show_mask_heatmaps else 0.5
        self.predictor = Predictor(self.cfg, model=model,
                                   device=next(model.parameters()).device,
                                   min_image_size=min_image_size,
                                   mask_threshold=self.mask_threshold)
        self.confidence_threshold = confidence_threshold
        self.show_mask_heatmaps = show_mask_heatmaps
        self.masks_per_dim = masks_per_dim

    # -- public API -------------------------------------------------------------

    def compute_prediction(self, original_image):
        """BoxList of the detections on the BGR uint8 image [H, W, 3]:
        "scores", "labels", for mask models "mask" [N, H, W] uint8 and for
        keypoint models "keypoints"."""
        out = self.predictor.compute_prediction(original_image)
        h, w = original_image.shape[:2]
        prediction = BoxList(out["boxes"], (w, h), mode="xyxy")
        prediction.add_field("scores", out["scores"])
        prediction.add_field("labels", out["labels"])
        if "masks" in out:
            prediction.add_field("mask", out["masks"])
        if "keypoints" in out:
            prediction.add_field("keypoints", DetectionKeypoints(out["keypoints"], (w, h)))
        return prediction

    def select_top_predictions(self, predictions):
        """The detections scoring above confidence_threshold, best first."""
        keep = np.nonzero(np.asarray(predictions.get_field("scores"))
                          > self.confidence_threshold)[0]
        predictions = predictions[keep]
        idx = np.argsort(-np.asarray(predictions.get_field("scores")))
        return predictions[idx]

    def run_on_opencv_image(self, image):
        """The BGR uint8 image with the top detections drawn on a copy (or,
        with show_mask_heatmaps, the montage of their mask probabilities)."""
        predictions = self.compute_prediction(image)
        return self.draw(image, self.select_top_predictions(predictions))

    def draw(self, image, top_predictions):
        """run_on_opencv_image's drawing of already selected detections."""
        result = image.copy()
        if self.show_mask_heatmaps:
            return self.create_mask_montage(result, top_predictions)
        result = self.overlay_boxes(result, top_predictions)
        if self.cfg.MODEL.MASK_ON and top_predictions.has_field("mask"):
            result = self.overlay_mask(result, top_predictions)
        if self.cfg.MODEL.KEYPOINT_ON and top_predictions.has_field("keypoints"):
            result = self.overlay_keypoints(result, top_predictions)
        return self.overlay_class_names(result, top_predictions)

    # -- drawing ------------------------------------------------------------------
    # Per-class colors come from a golden-angle hue wheel (class_color):
    # consecutive class ids land ~137.5 degrees apart on the hue circle.

    def class_color(self, label):
        """Deterministic BGR color for a class id."""
        hue = (int(label) * 0.61803398875) % 1.0
        r, g, b = colorsys.hsv_to_rgb(hue, 0.85, 0.95)
        return int(b * 255), int(g * 255), int(r * 255)

    def overlay_boxes(self, image, predictions):
        """Each box's 1-pixel outline in its class color."""
        labels = np.asarray(predictions.get_field("labels"))
        boxes = np.asarray(predictions.bbox, np.int64)
        for (x0, y0, x1, y1), label in zip(boxes.tolist(), labels.tolist()):
            draw.rectangle(image, (x0, y0), (x1, y1), self.class_color(label), 1)
        return image

    def overlay_mask(self, image, predictions):
        """Each mask filled at 0.45 of its class color over 0.55 of the
        image, with a hard border: the mask dilated twice minus the mask
        eroded once (3 x 3)."""
        masks = np.asarray(predictions.get_field("mask")).astype(np.uint8)
        labels = np.asarray(predictions.get_field("labels"))
        if masks.ndim == 4:
            masks = masks[:, 0]
        for mask, label in zip(masks, labels.tolist()):
            color = np.asarray(self.class_color(label), np.float32)
            inside = mask.astype(bool)
            image[inside] = (0.55 * image[inside] + 0.45 * color).astype(np.uint8)
            border = draw.dilate(mask, 2) - draw.erode(mask, 1)
            image[border.astype(bool)] = color.astype(np.uint8)
        return image

    def overlay_keypoints(self, image, predictions):
        keypoints = np.asarray(predictions.get_field("keypoints"))  # [N, K, 4]
        for inst in keypoints:
            image = draw_person_skeleton(image, inst[:, :2], inst[:, 3], self.class_color)
        return image

    def create_mask_montage(self, image, predictions):
        """The first masks_per_dim^2 mask probability maps, each resized by
        1 / masks_per_dim, tiled into one grid and colored with JET."""
        masks = np.asarray(predictions.get_field("mask"), np.float32)
        if masks.ndim == 4:
            masks = masks[:, 0]
        d = self.masks_per_dim
        if len(masks) == 0:
            return image
        tiles = [draw.resize_by(m, d) for m in masks[:d * d]]
        th, tw = tiles[0].shape
        grid = np.zeros((d * d, th, tw), np.float32)
        grid[:len(tiles)] = np.stack(tiles)
        montage = grid.reshape(d, d, th, tw).swapaxes(1, 2).reshape(d * th, d * tw)
        # the heatmap-mode masker pastes 0-255 probability maps; a
        # binary-mode masker would paste {0, 1}
        if montage.max() > 1.0:
            montage = montage / 255.0
        return draw.apply_jet(np.uint8(np.clip(montage, 0, 1) * 255))

    def label_boxes(self, predictions):
        """[(text, (x0, y0), (x1, y1))] of each detection's label: its text
        and the corners of its backdrop, as overlay_class_names draws them."""
        scores = np.asarray(predictions.get_field("scores")).tolist()
        labels = np.asarray(predictions.get_field("labels")).tolist()
        boxes = np.asarray(predictions.bbox, np.int64).tolist()
        out = []
        for box, score, label in zip(boxes, scores, labels):
            text = "{}: {:.2f}".format(self.CATEGORIES[int(label)], score)
            (tw, th), base = draw.text_size(text)
            x, y = box[0], max(box[1], th + base)
            out.append((text, (x, y - th - base), (x + tw, y)))
        return out

    def overlay_class_names(self, image, predictions):
        """Label text in black on a filled backdrop in the class color."""
        labels = np.asarray(predictions.get_field("labels")).tolist()
        for (text, p0, p1), label in zip(self.label_boxes(predictions), labels):
            draw.rectangle(image, p0, p1, self.class_color(label), -1)
            draw.put_text(image, text, (p0[0], p1[1] - draw.BASELINE), (0, 0, 0))
        return image


def draw_person_skeleton(img, xy, score, color_fn, thresh=2.0, alpha=0.7):
    """Draw one COCO-person skeleton on a copy of `img` blended back at
    `alpha` (cv2.addWeighted's rounding). xy [K, 2], score [K]: decoded
    keypoints; joints at or below `thresh` are skipped. Limbs take
    color_fn(limb + 1); two more segments (nose to the shoulders' centre,
    shoulders' centre to the hips' centre) complete the torso. Strokes are
    solid: lines 2 pixels wide, joints discs of radius 3."""
    names = PersonKeypoints.NAMES
    limbs = list(PersonKeypoints.CONNECTIONS)

    def center(a, b):
        ia, ib = names.index(a), names.index(b)
        return (xy[ia] + xy[ib]) / 2.0, min(score[ia], score[ib])

    canvas = img.copy()
    mid_sh, s_sh = center("right_shoulder", "left_shoulder")
    mid_hip, s_hip = center("right_hip", "left_hip")
    nose = names.index("nose")
    extras = [(mid_sh, s_sh, xy[nose], score[nose]), (mid_sh, s_sh, mid_hip, s_hip)]
    for li, (p, sp, q, sq) in enumerate(
            [(xy[a], score[a], xy[b], score[b]) for a, b in limbs] + extras):
        color = color_fn(li + 1)
        pi = tuple(int(v) for v in p)
        qi = tuple(int(v) for v in q)
        if sp > thresh and sq > thresh:
            draw.line(canvas, pi, qi, color, 2)
        if sp > thresh:
            draw.circle(canvas, pi, 3, color)
        if sq > thresh:
            draw.circle(canvas, qi, 3, color)
    return draw.add_weighted(img, 1.0 - alpha, canvas, alpha, 0)
