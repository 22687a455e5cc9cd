"""GeneralizedRCNN (inference) and build_detection_model.

PyTorch counterpart of maskrcnn_tpu/models/detector.py for the Mask R-CNN
FPN serving path, ``infer_forward``: device-side uint8 normalisation,
backbone, RPN head, proposals (NMS kernel), box head (ROIAlign kernel, P=7),
per-class post-processing (NMS kernel), mask head (ROIAlign kernel, P=14).

The public layouts are the JAX package's: images [B, H, W, 3], image_sizes
[B, 2] (h, w), and a padded detection dict with boxes [B, D, 4] xyxy,
scores, labels and valid [B, D], masks [B, D, M, M]. Inside, activations are
NCHW in channels_last memory format, so each pyramid level handed to the
pooler is a free NHWC view.

RetinaNet, keypoint, RPN-only and C4 models wait for later slices, and so
does training.
"""

import torch
import torch.nn as nn

from .anchors import make_anchor_generator
from .backbone import build_backbone
from .poolers import PoolerConfig, multilevel_roi_align
from .roi_heads.box_head import BoxHead, box_head_inference
from .roi_heads.mask_head import MaskHead
from .rpn import RPNHead, select_proposals

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _flatten_rois(boxes):
    """[B, K, 4] -> ([B*K, 4], batch_idx [B*K] int32)."""
    b, k, _ = boxes.shape
    idx = torch.arange(b, dtype=torch.int32, device=boxes.device).repeat_interleave(k)
    return boxes.reshape(b * k, 4), idx


def _nhwc(features):
    return [f.permute(0, 2, 3, 1) for f in features]


class GeneralizedRCNN(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        m = cfg.MODEL
        if m.RETINANET_ON or m.KEYPOINT_ON or m.RPN_ONLY:
            raise NotImplementedError(
                "RetinaNet, keypoint and RPN-only models are not ported yet")
        if m.RPN.RPN_HEAD != "SingleConvRPNHead":
            raise NotImplementedError("RPN head {} is not ported yet".format(m.RPN.RPN_HEAD))
        self.cfg = cfg.clone()
        self.compute_dtype = _DTYPES[cfg.TPU.COMPUTE_DTYPE]
        self.register_buffer("pixel_mean", torch.tensor(cfg.INPUT.PIXEL_MEAN, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.INPUT.PIXEL_STD, dtype=torch.float32),
                             persistent=False)
        self.to_bgr255 = cfg.INPUT.TO_BGR255
        self.mask_on = m.MASK_ON

        self.backbone = build_backbone(cfg)
        self.anchor_gen = make_anchor_generator(cfg)
        c = self.backbone.out_channels
        self.rpn = RPNHead(c, self.anchor_gen.num_anchors_per_location()[0])
        self.roi_heads = nn.Module()
        self.roi_heads.box = BoxHead(cfg, c)
        self.box_pooler = PoolerConfig(
            m.ROI_BOX_HEAD.POOLER_RESOLUTION, m.ROI_BOX_HEAD.POOLER_SCALES,
            m.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO,
        )
        if self.mask_on:
            self.roi_heads.mask = MaskHead(cfg, c)
            self.mask_pooler = PoolerConfig(
                m.ROI_MASK_HEAD.POOLER_RESOLUTION, m.ROI_MASK_HEAD.POOLER_SCALES,
                m.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO,
            )

    def reset_parameters(self, gen):
        """Seeded init with the distributions of the JAX model.init."""
        self.backbone.reset_parameters(gen)
        self.rpn.reset_parameters(gen)
        self.roi_heads.box.reset_parameters(gen)
        if self.mask_on:
            self.roi_heads.mask.reset_parameters(gen)

    def _normalize_uint8(self, images, image_sizes):
        """RGB uint8 [B, H, W, 3] -> normalized float32, padded region
        re-zeroed (detector._normalize_uint8)."""
        x = images.float()
        if self.to_bgr255:
            x = x.flip(-1)
        else:
            x = x / 255.0
        x = (x - self.pixel_mean) / self.pixel_std
        _, h, w, _ = x.shape
        ys = torch.arange(h, device=x.device)[None, :, None, None]
        xs = torch.arange(w, device=x.device)[None, None, :, None]
        inside = (ys < image_sizes[:, 0][:, None, None, None]) & (
            xs < image_sizes[:, 1][:, None, None, None]
        )
        return torch.where(inside, x, torch.zeros((), device=x.device))

    def _prepare_images(self, images, image_sizes):
        """uint8 batches are normalized here; float batches are taken as
        already normalized and zero-padded."""
        if images.dtype == torch.uint8:
            return self._normalize_uint8(images, image_sizes)
        return images

    @torch.inference_mode()
    def infer_forward(self, batch):
        """batch: images [B, H, W, 3] (uint8 RGB or normalized float32),
        image_sizes [B, 2] int. Returns the padded detection dict."""
        cfg = self.cfg
        image_sizes = batch["image_sizes"]
        images = self._prepare_images(batch["images"], image_sizes)
        x = images.permute(0, 3, 1, 2).to(self.compute_dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        features = self.backbone(x)
        anchors = [
            self.anchor_gen.grid_anchors_level(l, f.shape[2], f.shape[3], f.device)
            for l, f in enumerate(features)
        ]
        objectness, bbox_reg = self.rpn(features)
        prop_boxes, prop_scores, prop_valid = select_proposals(
            anchors, objectness, bbox_reg, image_sizes, cfg.MODEL.RPN
        )

        nhwc = _nhwc(features)
        rois, batch_idx = _flatten_rois(prop_boxes)
        pooled = multilevel_roi_align(
            nhwc[: len(self.box_pooler.scales)], rois, batch_idx, self.box_pooler
        )
        class_logits, box_regression = self.roi_heads.box(pooled)
        b, n = prop_scores.shape
        h = cfg.MODEL.ROI_HEADS
        detections = box_head_inference(
            class_logits.reshape(b, n, -1), box_regression.reshape(b, n, -1),
            prop_boxes, prop_valid, image_sizes, tuple(h.BBOX_REG_WEIGHTS),
            h.SCORE_THRESH, h.NMS, h.DETECTIONS_PER_IMG,
            cls_agnostic=cfg.MODEL.CLS_AGNOSTIC_BBOX_REG,
        )
        if self.mask_on:
            det_rois, det_batch = _flatten_rois(detections["boxes"])
            pooled = multilevel_roi_align(
                nhwc[: len(self.mask_pooler.scales)], det_rois, det_batch,
                self.mask_pooler,
            )
            probs = self.roi_heads.mask(pooled, detections["labels"].reshape(-1))
            d = detections["boxes"].shape[1]
            detections["masks"] = probs.reshape(b, d, probs.shape[-2], probs.shape[-1])
        return detections


def build_detection_model(cfg, device="cuda", seed=0):
    """The model of `cfg` with seeded random weights, on `device` (the card
    unless the caller asks for "cpu")."""
    if cfg.MODEL.META_ARCHITECTURE != "GeneralizedRCNN":
        raise ValueError("Unknown META_ARCHITECTURE {}".format(cfg.MODEL.META_ARCHITECTURE))
    model = GeneralizedRCNN(cfg)
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    return model.to(device).eval()
