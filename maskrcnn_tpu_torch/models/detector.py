"""GeneralizedRCNN (training and inference) and build_detection_model.

PyTorch counterpart of maskrcnn_tpu/models/detector.py for Mask R-CNN with
an FPN or a C4 body:

* ``train_forward``: backbone, RPN head, RPN loss (matcher kernel), training
  proposals (NMS kernel), box targets and loss (ROIAlign kernel, P=7), the
  positives compacted across images, mask targets and loss (ROIAlign
  kernel, P=14), keypoint targets and loss (ROIAlign kernel, P=14); the
  ROIAlign backward kernel carries the heads' gradient into the pyramid.
* ``infer_forward``: device-side uint8 normalisation, backbone, RPN head,
  proposals, box head, per-class post-processing (NMS kernel), mask head,
  keypoint head.

The public layouts are the JAX package's: images [B, H, W, 3], image_sizes
[B, 2] (h, w), gt_boxes [B, G, 4], gt_labels [B, G] (0 = padding), gt_masks
[B, G, S, S], gt_keypoints [B, G, K, 3], and a padded detection dict with
boxes [B, D, 4] xyxy, scores, labels and valid [B, D], masks [B, D, M, M],
and either kp_heatmaps [B, D, H, H, K] float32 (the logits, for the exact
host decode) or, under TPU.KEYPOINT_DECODE_ON_DEVICE, keypoints
[B, D, K, 4] (x, y, 1, logit). Inside, activations are
NCHW in channels_last memory format, so each pyramid level handed to the
pooler is a free NHWC view.

Both passes wrap their stages in spans (utils/profiling.py:span, a
``record_function`` range while a profiler records, nothing otherwise)
named, placed and nested as the JAX package's ``jax.named_scope``s:
image_prep, backbone (the body's stem and layer1-4, and fpn, inside),
rpn_head, rpn_loss, proposals, box_targets, box_head, box_loss, mask_head,
mask_targets, keypoint_head and keypoint_loss in training; image_prep,
backbone, rpn_head, proposals, box_head, box_postproc and mask_head at
inference. RetinaNet's head and the inference keypoint head have none, as
in JAX. The port adds spans of its own (utils/profiling.py:PORT_SPANS):
"anchors" after the backbone (and, in training, around the anchors'
visibility), with "anchors.wait" inside; "proposals.candidates",
"proposals.nms" and "proposals.select" inside proposals (rpn.py);
"rpn_loss.match" inside rpn_loss; "box_postproc.nms" inside box_postproc
(box_head.py); "roi_pool" around every ROI pooling and "roi_pool.bwd"
around its kernels' backward (poolers.py); "group_norm" around every group
norm of a GN model (layers.py), inside the stage that calls it, and
"group_norm.bwd" around its kernels' backward. The spans
change no output; utils/profiling.py and the benchmark's readers read them.

The two samplers' uniform draws (``draws``: rpn_pos, rpn_neg [B, N
anchors], box_pos, box_neg [B, P proposals]) may be passed in; missing ones
come from the caller's torch.Generator.

In a process group each process's ``train_forward`` takes its share of the
global batch (data coordinates hold equal shares, in data-rank order; the
processes of one data coordinate, its model group, hold the same share) and
computes its share of the global batch's losses, as the JAX mesh step: the
draws are its rows of the global batch's draws (those passed in are the
global batch's; those drawn come from B * data_size rows), the losses divide
by the global counts (rpn.py, box_head.py, mask_head.py, keypoint_head.py,
ops/losses.py), and the mask and keypoint heads keep the positives that
their batch-wide caps keep over the global batch
(``_cut_positives_globally``).

Keypoint R-CNN (MODEL.KEYPOINT_ON): a proposal matched to a gt without a
visible joint inside its box is ignored by the box sampler; the keypoint
head takes the box head's positives (with or without a mask head), cut to
TPU.KEYPOINT_ROI_CAP per image over the batch, and pools them at P=14
through the ROIAlign kernel and its backward (the one
MASKRCNN_POOLER_BWD_P14 names, as the mask head's). At inference it pools
every detection slot (a fixed shape) and returns kp_heatmaps, or keypoints
decoded on the device.

RetinaNet (MODEL.RETINANET_ON, models/retinanet.py) has no ROI heads:
``train_forward`` returns loss_retina_cls and loss_retina_reg (the anchor
matcher kernel, no sampler draws), ``infer_forward`` the padded detection
dict without masks (the NMS kernel); MASK_ON and KEYPOINT_ON are off under
it, as in the JAX package.

RPN-only models (MODEL.RPN_ONLY without RetinaNet, the rpn_* files) have
no ROI heads: ``train_forward`` returns loss_objectness and
loss_rpn_box_reg (the matcher kernel, no proposals, so no NMS), and
``infer_forward`` the proposals as the detections (the NMS kernel): boxes,
scores (the objectness), labels 1 and valid, in select_proposals' order.

FBNet models (CONV_BODY "FBNet", models/fbnet.py): one map at stride 16,
RPN_HEAD "FBNet.rpn_head", the box head's FBNet.roi_head and the mask
head's FBNet.roi_head_mask with MaskRCNNConv1x1Predictor; their poolers are
single-level, so they take the adaptive pooler as C4 does.

C4 models (R-50-C4: one map at stride 16, 15 anchors a location) pool at
POOLER_SAMPLING_RATIO 0 through the adaptive pooler: on the card the
ROIAlign kernels' adaptive instances, on the CPU its plain paths
(models/poolers.py:adaptive_roi_align), where the box ROIs of each image are
a block of the sampled batch (training) or of the proposals (inference), so
they take its matmul path. The box head's extractor is the res5 head. With
SHARE_BOX_FEATURE_EXTRACTOR the mask head's input is the box pooler and the
box extractor on the mask ROIs: the positives in training, the detection
slots at inference (on the CPU the gather and the matmul path).
"""

import torch
import torch.nn as nn

from ..ops.sampler import top_k_fast, uniform_draws
from ..utils import comm
from ..utils.profiling import span
from .anchors import make_anchor_generator, make_anchor_generator_retinanet
from .backbone import build_backbone
from .fbnet import FBNetRPNHead
from .poolers import PoolerConfig, multilevel_roi_align
from .registry import META_ARCHITECTURES
from .roi_heads.box_head import BoxHead, box_head_inference, box_head_loss, prepare_box_targets
from .roi_heads.keypoint_head import (
    KeypointHead,
    heatmaps_to_keypoints,
    keypoint_head_loss,
    keypoints_within_box_filter,
)
from .roi_heads.mask_head import (
    MaskHead,
    mask_head_loss_picked,
    project_gt_masks,
    select_positive_rois,
)
from .retinanet import RetinaNetHead, retinanet_inference, retinanet_loss
from .rpn import RPNHead, rpn_loss, select_proposals

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RPN_HEADS = {"SingleConvRPNHead": lambda cfg, c, a: RPNHead(c, a),
             "FBNet.rpn_head": FBNetRPNHead}


def _flatten_rois(boxes):
    """[B, K, 4] -> ([B*K, 4], batch_idx [B*K] int32)."""
    b, k, _ = boxes.shape
    idx = torch.arange(b, dtype=torch.int32, device=boxes.device).repeat_interleave(k)
    return boxes.reshape(b * k, 4), idx


def _nhwc(features):
    """NHWC views of the levels for the pooler: free for channels_last maps
    (cuDNN keeps that layout), a copy otherwise."""
    return [f.permute(0, 2, 3, 1).contiguous() for f in features]


def _compact_positives(pos_state, cap):
    """Pack the valid positive ROIs of the whole batch into `cap` rows
    (TPU.MASK_ROI_CAP or KEYPOINT_ROI_CAP per image, batch-wide), in their
    original order.
    pos_state = (rois [R, 4], batch_idx [R], valid [R], labels [R],
    matched_gt [R]); cap <= 0 or cap >= R keeps all rows."""
    valid = pos_state[2]
    if not 0 < cap < valid.shape[0]:
        return pos_state
    sel = torch.sort(top_k_fast(valid.float(), cap)[1]).values
    return tuple(x[sel] for x in pos_state)


def _cut_positives_globally(pos_state, cap, b):
    """The batch-wide cap of _compact_positives over the global batch of a
    process group: the first `cap` * (global images) valid positives of the
    global batch in order (data coordinates in order, each holding `b`
    images) are kept, wherever they lie, so this process keeps its valid rows whose
    place in that order is below the cap. Rows are not compacted: a process
    may hold every kept positive. Returns pos_state with the cut validity.
    """
    rois, batch_idx, valid, labels, mg = pos_state
    if cap <= 0:
        return pos_state
    counts = comm.gather_rows(torch.stack([valid.sum(), valid.new_tensor(b, dtype=torch.int64)]))
    offset = counts[:comm.data_rank(), 0].sum()
    place = offset + torch.cumsum(valid.long(), 0) - 1
    keep = valid & (place < cap * counts[:, 1].sum())
    return rois, batch_idx, keep, labels, mg


def _level_major(per_level, b, last):
    """Head outputs [B, A*last, H, W] per level -> [B, sum H*W*A, last] in
    the JAX NHWC flatten order (y, x, anchor)."""
    return torch.cat([t.permute(0, 2, 3, 1).reshape(b, -1, last) for t in per_level], dim=1)


class GeneralizedRCNN(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        m = cfg.MODEL
        self.retinanet_on = m.RETINANET_ON
        self.rpn_only = m.RPN_ONLY and not self.retinanet_on
        if not self.retinanet_on and m.RPN.RPN_HEAD not in RPN_HEADS:
            raise NotImplementedError("RPN head {} is not ported yet".format(m.RPN.RPN_HEAD))
        self.cfg = cfg.clone()
        self.compute_dtype = _DTYPES[cfg.TPU.COMPUTE_DTYPE]
        self.register_buffer("pixel_mean", torch.tensor(cfg.INPUT.PIXEL_MEAN, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(cfg.INPUT.PIXEL_STD, dtype=torch.float32),
                             persistent=False)
        self.to_bgr255 = cfg.INPUT.TO_BGR255
        self.mask_on = m.MASK_ON and not self.retinanet_on
        self.keypoint_on = m.KEYPOINT_ON and not self.retinanet_on
        # fixed positive-ROI batch of the mask and keypoint heads: the box
        # sampler's quota
        self.num_pos_rois = int(m.ROI_HEADS.BATCH_SIZE_PER_IMAGE * m.ROI_HEADS.POSITIVE_FRACTION)

        self.backbone = build_backbone(cfg)
        c = self.backbone.out_channels
        if self.retinanet_on:
            self.anchor_gen = make_anchor_generator_retinanet(cfg)
            self.rpn = RetinaNetHead(cfg, c)
            return
        self.anchor_gen = make_anchor_generator(cfg)
        self.rpn = RPN_HEADS[m.RPN.RPN_HEAD](cfg, c, self.anchor_gen.num_anchors_per_location()[0])
        if self.rpn_only:
            return
        self.roi_heads = nn.Module()
        self.roi_heads.box = BoxHead(cfg, c)
        self.box_pooler = PoolerConfig(
            m.ROI_BOX_HEAD.POOLER_RESOLUTION, m.ROI_BOX_HEAD.POOLER_SCALES,
            m.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO,
        )
        if self.mask_on:
            self.share_mask_fe = m.ROI_MASK_HEAD.SHARE_BOX_FEATURE_EXTRACTOR
            shared = self.roi_heads.box.feature_extractor.out_dim if self.share_mask_fe else None
            self.roi_heads.mask = MaskHead(cfg, c, shared_dim=shared)
            self.mask_pooler = PoolerConfig(
                m.ROI_MASK_HEAD.POOLER_RESOLUTION, m.ROI_MASK_HEAD.POOLER_SCALES,
                m.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO,
            )
        if self.keypoint_on:
            self.roi_heads.keypoint = KeypointHead(cfg, c)
            self.kp_pooler = PoolerConfig(
                m.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION, m.ROI_KEYPOINT_HEAD.POOLER_SCALES,
                m.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO,
            )

    def reset_parameters(self, gen):
        """Seeded init with the distributions of the JAX model.init."""
        self.backbone.reset_parameters(gen)
        self.rpn.reset_parameters(gen)
        if self.retinanet_on or self.rpn_only:
            return
        self.roi_heads.box.reset_parameters(gen)
        if self.mask_on:
            self.roi_heads.mask.reset_parameters(gen)
        if self.keypoint_on:
            self.roi_heads.keypoint.reset_parameters(gen)

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

    def _mask_features(self, nhwc, rois, batch_idx, rois_per_image=None):
        """The mask predictor's input on `rois`: the box pooler and the box
        extractor when the mask head shares it, else the mask pooler's
        output for the mask head's own extractor (MaskHead.features)."""
        if self.share_mask_fe:
            pooled = multilevel_roi_align(nhwc[: len(self.box_pooler.scales)], rois, batch_idx,
                                          self.box_pooler, rois_per_image=rois_per_image)
            return self.roi_heads.box.feature_extractor(pooled)
        return multilevel_roi_align(nhwc[: len(self.mask_pooler.scales)], rois, batch_idx,
                                    self.mask_pooler, rois_per_image=rois_per_image)

    def _prepare_images(self, images, image_sizes):
        """uint8 batches are normalized here; float batches are taken as
        already normalized and zero-padded."""
        if images.dtype == torch.uint8:
            return self._normalize_uint8(images, image_sizes)
        return images

    def _backbone(self, batch):
        with span("image_prep"):
            images = self._prepare_images(batch["images"], batch["image_sizes"])
        with span("backbone"):
            x = images.permute(0, 3, 1, 2).to(self.compute_dtype)
            features = self.backbone(x.contiguous(memory_format=torch.channels_last))
        with span("anchors"):
            anchors = [
                self.anchor_gen.grid_anchors_level(l, f.shape[2], f.shape[3], f.device)
                for l, f in enumerate(features)
            ]
        return features, anchors

    def train_forward(self, batch, draws=None, generator=None):
        """batch: images [B, H, W, 3] (uint8 RGB or normalized float32),
        image_sizes [B, 2], gt_boxes [B, G, 4], gt_labels [B, G], gt_masks
        [B, G, S, S] (mask models), gt_keypoints [B, G, K, 3] (keypoint
        models). draws: optional dict of the samplers' uniform draws
        (rpn_pos, rpn_neg [B, N]; box_pos, box_neg [B, P]); the missing
        ones are drawn with `generator`. Returns the losses: the RPN's and box
        head's, loss_mask and loss_kp of the heads the model has."""
        cfg = self.cfg
        hcfg = cfg.MODEL.ROI_HEADS
        rcfg = cfg.MODEL.RPN
        draws = dict(draws or {})
        image_sizes = batch["image_sizes"]
        gt_boxes = batch["gt_boxes"].float()
        gt_labels = batch["gt_labels"]
        gt_valid = gt_labels > 0
        if self.retinanet_on:
            return self._retinanet_train_forward(batch, gt_boxes, gt_labels)

        rank, world = comm.data_rank(), comm.data_size()

        def draw(kind, n):
            """This process's rows of the global batch's draws."""
            if kind + "_pos" not in draws:
                if generator is None:
                    raise ValueError("no {} sampler draws given and no generator".format(kind))
                draws[kind + "_pos"], draws[kind + "_neg"] = uniform_draws(
                    (b * world, n), generator, gt_boxes.device)
            return tuple(draws[kind + s][rank * b:(rank + 1) * b] for s in ("_pos", "_neg"))

        features, anchors = self._backbone(batch)
        with span("rpn_head"):
            objectness, bbox_reg = self.rpn(features)
        b = gt_boxes.shape[0]
        with span("anchors"):
            cat_anchors = torch.cat(anchors)
            h = image_sizes[:, 0:1].float()
            w = image_sizes[:, 1:2].float()
            visible = self.anchor_gen.visibility(cat_anchors, h, w)
        obj_cat, reg_cat = _level_major(objectness, b, 1)[..., 0], _level_major(bbox_reg, b, 4)
        with span("rpn_loss"):
            rpn_pos, rpn_neg = draw("rpn", cat_anchors.shape[0])
            loss_obj, loss_rpn_box = rpn_loss(
                cat_anchors, visible, obj_cat, reg_cat, gt_boxes, gt_valid, rpn_pos, rpn_neg,
                rcfg.FG_IOU_THRESHOLD, rcfg.BG_IOU_THRESHOLD, rcfg.BATCH_SIZE_PER_IMAGE,
                rcfg.POSITIVE_FRACTION,
            )
        losses = {"loss_objectness": loss_obj, "loss_rpn_box_reg": loss_rpn_box}
        if self.rpn_only:
            return losses

        with torch.no_grad():
            with span("proposals"):
                prop_boxes, _, prop_valid = select_proposals(
                    anchors, [o.detach() for o in objectness], [r.detach() for r in bbox_reg],
                    image_sizes, rcfg, is_train=True, gt_boxes=gt_boxes, gt_valid=gt_valid,
                )
            gt_usable = None
            if self.keypoint_on:
                gt_usable = keypoints_within_box_filter(batch["gt_keypoints"].float(), gt_boxes)
            with span("box_targets"):
                box_pos, box_neg = draw("box", prop_boxes.shape[1])
                targets = prepare_box_targets(
                    prop_boxes, prop_valid, gt_boxes, gt_labels, box_pos, box_neg,
                    hcfg.FG_IOU_THRESHOLD, hcfg.BG_IOU_THRESHOLD, hcfg.BATCH_SIZE_PER_IMAGE,
                    hcfg.POSITIVE_FRACTION, tuple(hcfg.BBOX_REG_WEIGHTS), gt_usable=gt_usable,
                )

        rois, batch_idx = _flatten_rois(targets["rois"])
        with span("box_head"):
            nhwc = _nhwc(features)
            pooled = multilevel_roi_align(nhwc[: len(self.box_pooler.scales)], rois, batch_idx,
                                          self.box_pooler,
                                          rois_per_image=targets["rois"].shape[1])
            class_logits, box_regression = self.roi_heads.box(pooled)
        with span("box_loss"):
            losses["loss_classifier"], losses["loss_box_reg"] = box_head_loss(
                class_logits, box_regression, targets,
                cls_agnostic=cfg.MODEL.CLS_AGNOSTIC_BBOX_REG)

        if self.mask_on or self.keypoint_on:
            with torch.no_grad():
                pos_idx, pos_valid = select_positive_rois(targets, self.num_pos_rois)
                rows = torch.arange(b, device=pos_idx.device)[:, None]
                pos_rois, pos_batch = _flatten_rois(targets["rois"][rows, pos_idx])
                pos_state = (pos_rois, pos_batch, pos_valid.reshape(-1),
                             targets["labels"][rows, pos_idx].reshape(-1),
                             targets["matched_gt_idx"][rows, pos_idx].reshape(-1))

        def capped(cap):
            """The positives the batch-wide cap of `cap` per image keeps."""
            with torch.no_grad():
                if world > 1:
                    return _cut_positives_globally(pos_state, cap, b)
                return _compact_positives(pos_state, cap * b)

        if self.mask_on:
            m_rois, m_batch, m_valid, m_labels, m_mg = capped(cfg.TPU.MASK_ROI_CAP)
            with span("mask_head"):
                x = self._mask_features(nhwc, m_rois, m_batch)
                mask_logits = self.roi_heads.mask.logits_at_class(x, m_labels)
            with span("mask_targets"):
                with torch.no_grad():
                    gt_masks = batch["gt_masks"]
                    g, s = gt_masks.shape[1], gt_masks.shape[-1]
                    flat_ix = m_batch.long() * g + m_mg
                    tgt = project_gt_masks(gt_masks.reshape(-1, s, s)[flat_ix],
                                           gt_boxes.reshape(-1, 4)[flat_ix], m_rois,
                                           mask_logits.shape[1])
                losses["loss_mask"] = mask_head_loss_picked(mask_logits, tgt, m_valid)

        if self.keypoint_on:
            k_rois, k_batch, k_valid, _, k_mg = capped(cfg.TPU.KEYPOINT_ROI_CAP)
            with torch.no_grad():
                gt_kps = batch["gt_keypoints"].float()
                g, kk = gt_kps.shape[1], gt_kps.shape[2]
                kp_targets = gt_kps.reshape(-1, kk, 3)[k_batch.long() * g + k_mg]
            with span("keypoint_head"):
                pooled = multilevel_roi_align(nhwc[: len(self.kp_pooler.scales)], k_rois,
                                              k_batch, self.kp_pooler)
                kp_logits = self.roi_heads.keypoint(pooled)
            with span("keypoint_loss"):
                losses["loss_kp"] = keypoint_head_loss(kp_logits, kp_targets, k_rois, k_valid)
        return losses

    def _retinanet_train_forward(self, batch, gt_boxes, gt_labels):
        features, anchors = self._backbone(batch)
        cls, reg = self.rpn(features)
        b = gt_boxes.shape[0]
        cls_loss, reg_loss = retinanet_loss(
            torch.cat(anchors), _level_major(cls, b, self.rpn.num_classes),
            _level_major(reg, b, 4), gt_boxes, gt_labels, self.cfg.MODEL.RETINANET)
        return {"loss_retina_cls": cls_loss, "loss_retina_reg": reg_loss}

    @torch.inference_mode()
    def infer_forward(self, batch):
        """batch: images [B, H, W, 3] (uint8 RGB or normalized float32),
        image_sizes [B, 2] int. Returns the padded detection dict."""
        cfg = self.cfg
        image_sizes = batch["image_sizes"]
        features, anchors = self._backbone(batch)
        if self.retinanet_on:
            cls, reg = self.rpn(features)
            return retinanet_inference(anchors, cls, reg, image_sizes, cfg.MODEL.RETINANET,
                                       cfg.TEST.DETECTIONS_PER_IMG)
        with span("rpn_head"):
            objectness, bbox_reg = self.rpn(features)
        with span("proposals"):
            prop_boxes, prop_scores, prop_valid = select_proposals(
                anchors, objectness, bbox_reg, image_sizes, cfg.MODEL.RPN
            )
        if self.rpn_only:
            return dict(boxes=prop_boxes, scores=prop_scores, valid=prop_valid,
                        labels=torch.ones(prop_scores.shape, dtype=torch.int32,
                                          device=prop_scores.device))

        rois, batch_idx = _flatten_rois(prop_boxes)
        with span("box_head"):
            nhwc = _nhwc(features)
            pooled = multilevel_roi_align(
                nhwc[: len(self.box_pooler.scales)], rois, batch_idx, self.box_pooler,
                rois_per_image=prop_boxes.shape[1],
            )
            class_logits, box_regression = self.roi_heads.box(pooled)
        b, n = prop_scores.shape
        h = cfg.MODEL.ROI_HEADS
        with span("box_postproc"):
            detections = box_head_inference(
                class_logits.reshape(b, n, -1), box_regression.reshape(b, n, -1),
                prop_boxes, prop_valid, image_sizes, tuple(h.BBOX_REG_WEIGHTS),
                h.SCORE_THRESH, h.NMS, h.DETECTIONS_PER_IMG,
                cls_agnostic=cfg.MODEL.CLS_AGNOSTIC_BBOX_REG,
            )
        if self.mask_on:
            det_rois, det_batch = _flatten_rois(detections["boxes"])
            d = detections["boxes"].shape[1]
            with span("mask_head"):
                x = self._mask_features(nhwc, det_rois, det_batch, rois_per_image=d)
                probs = self.roi_heads.mask(x, detections["labels"].reshape(-1))
            detections["masks"] = probs.reshape(b, d, probs.shape[-2], probs.shape[-1])
        if self.keypoint_on:
            det_rois, det_batch = _flatten_rois(detections["boxes"])
            pooled = multilevel_roi_align(nhwc[: len(self.kp_pooler.scales)], det_rois,
                                          det_batch, self.kp_pooler)
            kp_logits = self.roi_heads.keypoint(pooled).float()  # [B*D, K, H, H]
            d = detections["boxes"].shape[1]
            if cfg.TPU.KEYPOINT_DECODE_ON_DEVICE:
                kps = heatmaps_to_keypoints(kp_logits, det_rois)
                detections["keypoints"] = kps.reshape(b, d, -1, 4)
            else:
                hh = kp_logits.shape[-1]
                detections["kp_heatmaps"] = kp_logits.permute(0, 2, 3, 1).reshape(
                    b, d, hh, hh, -1)
        return detections


def build_detection_model(cfg, device="cuda", seed=0):
    """The model of `cfg` with seeded random weights, on `device` (the card
    unless the caller asks for "cpu"). A MODEL.META_ARCHITECTURE registered
    in models/registry.py's META_ARCHITECTURES is built from the config
    first (its reset_parameters(generator), when it has one, draws the
    weights), as the JAX package consults that registry."""
    meta = cfg.MODEL.META_ARCHITECTURE
    if meta in META_ARCHITECTURES:
        model = META_ARCHITECTURES[meta](cfg)
    elif meta == "GeneralizedRCNN":
        model = GeneralizedRCNN(cfg)
    else:
        raise ValueError("Unknown META_ARCHITECTURE {}".format(meta))
    if hasattr(model, "reset_parameters"):
        model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()
