"""Serving entry point: one BGR image in, detections on the original image out.

PyTorch counterpart of demo/predictor.py:COCODemo.compute_prediction with
engine/inference.py:detections_to_boxlists, without the drawing code. Every
step runs on the model's device:

  1. the BGR uint8 image is resized bilinearly (half-pixel centres, as
     cv2.INTER_LINEAR) so its short side is ``min_image_size`` (224 by
     default, as COCODemo's), unless its long side would then pass
     INPUT.MAX_SIZE_TEST, and rounded back to uint8 values;
  2. normalized ((x - PIXEL_MEAN) / PIXEL_STD, BGR at 0-255 when
     INPUT.TO_BGR255, else RGB / 255) and zero-padded to a multiple of
     DATALOADER.SIZE_DIVISIBILITY;
  3. ``GeneralizedRCNN.infer_forward``;
  4. the valid detections' boxes are rescaled to the original image and their
     masks pasted into it (models/masker.py); keypoint models' joints are
     decoded from their heatmaps on the host (the exact decode, as
     test_net's; or on the device under TPU.KEYPOINT_DECODE_ON_DEVICE) and
     rescaled with the boxes, as engine/inference.py's BoxLists are.

``compute_prediction`` returns numpy arrays: boxes [N, 4] xyxy, scores [N],
labels [N], for mask models masks [N, H, W] uint8, and for keypoint models
keypoints [N, K, 4] (x, y, 1, logit at the maximum) on the original image.
"""

import torch
import torch.nn.functional as F

from .engine.inference import DetectionKeypoints
from .models.detector import build_detection_model
from .models.roi_heads.keypoint_head import heatmaps_to_keypoints_exact
from .models.masker import paste_masks_in_image
from .utils.checkpoint import DetectronCheckpointer


def resized_size(h, w, min_size, max_size):
    """(new_h, new_w) of the demo's resize rule."""
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    return int(round(h * scale)), int(round(w * scale))


class Predictor:
    """Serves one model. ``model`` defaults to the model of ``cfg`` on
    ``device`` (the card unless the caller asks for "cpu"): seeded random
    weights, then, as COCODemo, MODEL.WEIGHT when set (a catalog:// name, a
    Detectron .pkl, a .pth; OUTPUT_DIR's last_checkpoint wins).
    ``min_image_size`` is the resized short side (COCODemo's argument of the
    same name; pass cfg.INPUT.MIN_SIZE_TEST to serve at the test size)."""

    def __init__(self, cfg, model=None, device="cuda", seed=0, min_image_size=224):
        self.cfg = cfg.clone()
        self.min_image_size = min_image_size
        self.device = torch.device(device)
        if model is None:
            model = build_detection_model(self.cfg, device=device, seed=seed)
            if cfg.MODEL.WEIGHT:
                DetectronCheckpointer(cfg, model, save_dir=cfg.OUTPUT_DIR).load(cfg.MODEL.WEIGHT)
        self.model = model
        self.pixel_mean = torch.tensor(cfg.INPUT.PIXEL_MEAN, dtype=torch.float32,
                                       device=self.device)
        self.pixel_std = torch.tensor(cfg.INPUT.PIXEL_STD, dtype=torch.float32,
                                      device=self.device)

    def preprocess(self, bgr_image):
        """BGR uint8 [H, W, 3] (numpy or tensor) -> (normalized, zero-padded
        float32 images [1, Hp, Wp, 3], image_sizes [1, 2] int32)."""
        img = torch.as_tensor(bgr_image).to(self.device)
        h, w = img.shape[:2]
        nh, nw = resized_size(h, w, self.min_image_size, self.cfg.INPUT.MAX_SIZE_TEST)
        x = img.permute(2, 0, 1)[None].float()
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False)
        x = x.round().clamp(0, 255)[0].permute(1, 2, 0)  # [nh, nw, 3] BGR
        if not self.cfg.INPUT.TO_BGR255:
            x = x.flip(-1) / 255.0
        x = (x - self.pixel_mean) / self.pixel_std
        div = max(self.cfg.DATALOADER.SIZE_DIVISIBILITY, 1)
        ph, pw = -(-nh // div) * div, -(-nw // div) * div
        images = F.pad(x, (0, 0, 0, pw - nw, 0, ph - nh))[None]
        sizes = torch.tensor([[nh, nw]], dtype=torch.int32, device=self.device)
        return images, sizes

    @torch.inference_mode()
    def compute_prediction(self, bgr_image):
        images, sizes = self.preprocess(bgr_image)
        det = self.model.infer_forward({"images": images, "image_sizes": sizes})
        valid = det["valid"][0]
        boxes = det["boxes"][0][valid]
        h, w = bgr_image.shape[:2]
        nh, nw = int(sizes[0, 0]), int(sizes[0, 1])
        ratio = torch.tensor([w / nw, h / nh, w / nw, h / nh], dtype=boxes.dtype,
                             device=boxes.device)
        boxes = boxes * ratio
        out = {
            "boxes": boxes,
            "scores": det["scores"][0][valid],
            "labels": det["labels"][0][valid],
        }
        if "masks" in det:
            out["masks"] = paste_masks_in_image(det["masks"][0][valid], boxes, h, w)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        if "keypoints" in det:
            kps = det["keypoints"][0][valid].cpu().numpy()
        elif "kp_heatmaps" in det:
            kps = heatmaps_to_keypoints_exact(det["kp_heatmaps"][0][valid].cpu().numpy(),
                                              det["boxes"][0][valid].cpu().numpy())
        else:
            return out
        out["keypoints"] = DetectionKeypoints(kps, (nw, nh)).resize((w, h)).data
        return out
