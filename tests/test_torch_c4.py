"""The port's C4 models against the JAX package's, on the CPU in float32:
the adaptive ROIAlign (POOLER_SAMPLING_RATIO 0) and its matmul path, the
single-level anchors and proposals, the res5 head, and Faster and Mask
R-CNN R-50-C4 from configs/e2e_{faster,mask}_rcnn_R_50_C4_1x.yaml at the
narrow widths of torch_port_fixtures (the body's C4 at 4 x 64 = 256
channels, its BACKBONE_OUT_CHANNELS), the JAX init with frozen BN redrawn
(numpy_params), on 256 x 320 images (a C4 map of 16 x 20: two adaptive
samples a bin an axis at most), with the samplers' draws JAX makes from its
key. Also the plain NMS on a 12,000-box lane, the C4 training lane's
length, against the JAX package's NMS.

Tolerances: pooled features 1e-5; anchors exact; proposals 1e-5;
the res5 head 1e-4 (convolutions summed in other orders); detections:
labels and validity exact, scores 1e-5, boxes 1e-3 px, masks 1e-4; losses
rtol 1e-5; every gradient within 2e-4 of the JAX gradient's max; NMS keep
decisions exact.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskrcnn_tpu.config import cfg as jax_defaults
from maskrcnn_tpu.models import build_detection_model as build_jax_model
from maskrcnn_tpu.models import poolers as jpool
from maskrcnn_tpu.models.anchors import make_anchor_generator as jax_anchor_generator
from maskrcnn_tpu.models.resnet import apply_res5_head, init_res5_head, make_res5_head_config
from maskrcnn_tpu.models.rpn import make_rpn_cfg
from maskrcnn_tpu.models.rpn import select_proposals as jax_select_proposals
from maskrcnn_tpu.ops.nms import batched_nms_mask
from maskrcnn_tpu.ops.roi_align import roi_align as jax_roi_align
from maskrcnn_tpu_torch.config import cfg as torch_defaults
from maskrcnn_tpu_torch.models import poolers
from maskrcnn_tpu_torch.models.anchors import make_anchor_generator
from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN
from maskrcnn_tpu_torch.models.resnet import ResNetHead
from maskrcnn_tpu_torch.models.rpn import select_proposals
from maskrcnn_tpu_torch.ops.nms import batched_nms_plain
from maskrcnn_tpu_torch.utils.convert import params_from_jax
from test_models import tiny
from torch_port_fixtures import (
    _redraw,
    jax_sampler_draws,
    narrow,
    numpy_params,
    random_boxes,
    train_batch,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = jax.random.PRNGKey(7)
HW = (256, 320)


def _c4_configs(name):
    jcfg, tcfg = jax_defaults.clone(), torch_defaults.clone()
    for c in (jcfg, tcfg):
        c.merge_from_file(os.path.join(REPO, "configs", name))
        narrow(tiny(c))
        c.MODEL.WEIGHT = ""
        c.MODEL.RESNETS.BACKBONE_OUT_CHANNELS = c.MODEL.RESNETS.RES2_OUT_CHANNELS * 4
    return jcfg, tcfg


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


# -- adaptive ROIAlign --------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6])
def test_adaptive_roi_align_matches_jax(n):
    """ROIs of n samples a bin down the rows and 7 - n across the columns
    (bins of n - 3/7 and 6 - n + 4/7 cells) against JAX roi_align at
    sampling_ratio 0 (a superset of 8) and the JAX pooler (the map's bound,
    here 7)."""
    rs = np.random.RandomState(n)
    feat = rs.randn(2, 48, 64, 16).astype(np.float32)
    p, r = 7, 8
    h, w = 7 * n - 3, 7 * (7 - n) - 3
    y0 = rs.uniform(0, 48 - h - 0.5, r)
    x0 = rs.uniform(0, 64 - w - 0.5, r)
    boxes = np.stack([x0, y0, x0 + w, y0 + h], 1).astype(np.float32)
    bidx = rs.randint(0, 2, r).astype(np.int32)
    pcfg = poolers.PoolerConfig(p, (1.0,), 0)
    got = poolers.multilevel_roi_align([torch.from_numpy(feat)], torch.from_numpy(boxes),
                                       torch.from_numpy(bidx), pcfg)
    assert poolers.multilevel_roi_align.launches == 0  # CPU tensors: the plain path
    want = jax.jit(lambda f, b, i: jax_roi_align(f, b, i, p, 1.0, sampling_ratio=0))(
        jnp.asarray(feat), jnp.asarray(boxes), jnp.asarray(bidx))
    _close(got, want, 1e-5)
    pooled = jax.jit(lambda f, b, i: jpool.multilevel_roi_align(
        [f], b, i, jpool.PoolerConfig(p, (1.0,), 0), jnp.float32))(
        jnp.asarray(feat), jnp.asarray(boxes), jnp.asarray(bidx))
    _close(got, pooled, 1e-5)
    _, wy = poolers.adaptive_axis_samples(torch.from_numpy(y0).float(),
                                          torch.full((r,), h / p), p, 7)
    assert ((wy[:, :7] > 0).sum(1) == n).all()


def _c4_rois(rs, b=2, k=6, hw=(320, 384)):
    boxes = np.stack([random_boxes(rs, k, 40, min(hw) - 40, 8, 200) for _ in range(b)])
    boxes = np.clip(boxes, 0, [hw[1] - 1, hw[0] - 1, hw[1] - 1, hw[0] - 1]).astype(np.float32)
    return boxes.reshape(-1, 4), np.repeat(np.arange(b, dtype=np.int32), k)


def test_c4_matmul_pool_matches_jax_and_the_gather_path(monkeypatch):
    rs = np.random.RandomState(0)
    feat = rs.randn(2, 20, 24, 32).astype(np.float32)
    boxes, bidx = _c4_rois(rs)
    pcfg = poolers.PoolerConfig(14, (1 / 16,), 0)
    s = 2  # min(8, ceil(20 / 14), ceil(24 / 14))
    tf = torch.from_numpy(feat)
    got = poolers.multilevel_roi_align([tf], torch.from_numpy(boxes), torch.from_numpy(bidx),
                                       pcfg, rois_per_image=6)
    direct = poolers.c4_matmul_pool(tf, torch.from_numpy(boxes), pcfg, 6, s)
    assert torch.equal(got, direct)
    jp = jpool.PoolerConfig(14, (1 / 16,), 0)
    want = jax.jit(lambda f, b: jpool._c4_matmul_pool(f, b, jp, 6, s, jnp.float32))(
        jnp.asarray(feat), jnp.asarray(boxes))
    _close(got, want, 1e-5)
    gather = poolers.multilevel_roi_align([tf], torch.from_numpy(boxes), torch.from_numpy(bidx),
                                          pcfg)
    _close(got, gather, 1e-5)

    # ROI chunks of 2 an image (recomputed in the backward) and the gather
    # path's ROI chunks of 4: the same values, and the same gradient
    leaf = tf.clone().requires_grad_()
    cot = torch.from_numpy(rs.randn(12, 14, 14, 32).astype(np.float32))
    (poolers.multilevel_roi_align([leaf], torch.from_numpy(boxes), torch.from_numpy(bidx), pcfg)
     * cot).sum().backward()
    want_grad = leaf.grad.clone()
    monkeypatch.setattr(poolers, "CHUNK_BYTES", 2 * 2 * 14 * 24 * 32 * 4 * 2)
    for per_image in (6, None):
        leaf.grad = None
        out = poolers.multilevel_roi_align([leaf], torch.from_numpy(boxes),
                                           torch.from_numpy(bidx), pcfg, rois_per_image=per_image)
        _close(out.detach(), gather, 1e-5)
        (out * cot).sum().backward()
        assert (leaf.grad - want_grad).abs().max() <= 2e-4 * want_grad.abs().max()
    monkeypatch.setattr(jpool, "_CHUNK_THRESHOLD_BYTES", 2 * 2 * 14 * 24 * 32 * 4 * 2)
    chunked = jax.jit(lambda f, b: jpool._c4_matmul_pool(f, b, jp, 6, s, jnp.float32))(
        jnp.asarray(feat), jnp.asarray(boxes))
    _close(got, chunked, 1e-5)


# -- anchors, proposals, res5 --------------------------------------------------------


def test_single_level_anchors_match_jax():
    jcfg, tcfg = _c4_configs("e2e_faster_rcnn_R_50_C4_1x.yaml")
    assert not tcfg.MODEL.RPN.USE_FPN and tuple(tcfg.MODEL.RPN.ANCHOR_STRIDE) == (16,)
    ja, ta = jax_anchor_generator(jcfg), make_anchor_generator(tcfg)
    assert ta.num_anchors_per_location() == ja.num_anchors_per_location() == [15]
    np.testing.assert_array_equal(ta.cell_anchors[0], np.asarray(ja.cell_anchors[0]))
    want = np.asarray(ja.grid_anchors_level(0, 16, 20))
    got = ta.grid_anchors_level(0, 16, 20, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    vis = ta.visibility(got, torch.tensor([[240.0]]), torch.tensor([[300.0]]))
    jvis = ja.visibility(jnp.asarray(want), 240.0, 300.0)
    np.testing.assert_array_equal(vis[0].numpy(), np.asarray(jvis))
    assert 0 < vis.sum() < vis.numel()


@pytest.mark.parametrize("is_train", [False, True])
def test_single_level_proposals_match_jax(is_train):
    """One level: POST_NMS_TOP_N per image, no FPN cut, the gt appended in
    training."""
    jcfg, tcfg = _c4_configs("e2e_faster_rcnn_R_50_C4_1x.yaml")
    for c in (jcfg, tcfg):
        c.MODEL.RPN.PRE_NMS_TOP_N_TRAIN, c.MODEL.RPN.POST_NMS_TOP_N_TRAIN = 1200, 300
        c.MODEL.RPN.PRE_NMS_TOP_N_TEST, c.MODEL.RPN.POST_NMS_TOP_N_TEST = 600, 150
    rs = np.random.RandomState(5)
    h, w = 16, 20
    obj = (rs.randn(2, h, w, 15) * 2).astype(np.float32)
    reg = (rs.randn(2, h, w, 60) * 0.3).astype(np.float32)
    sizes = np.array([[256, 320], [224, 300]], np.int32)
    gt = np.stack([random_boxes(rs, 4, 40, 200, 10, 90) for _ in range(2)])
    gt_valid = np.array([[True] * 4, [True, True, False, True]])
    anchors = np.asarray(jax_anchor_generator(jcfg).grid_anchors_level(0, h, w))
    kw = dict(gt_boxes=jnp.asarray(gt), gt_valid=jnp.asarray(gt_valid)) if is_train else {}
    jb, js, jv = jax.jit(lambda a, o, r, s: jax_select_proposals(
        a, o, r, s, make_rpn_cfg(jcfg), is_train, **kw))(
        [jnp.asarray(anchors)], [jnp.asarray(obj)], [jnp.asarray(reg)], jnp.asarray(sizes))
    tkw = dict(gt_boxes=torch.from_numpy(gt), gt_valid=torch.from_numpy(gt_valid)) \
        if is_train else {}
    tb, ts, tv = select_proposals(
        [torch.from_numpy(anchors)], [torch.from_numpy(obj).permute(0, 3, 1, 2)],
        [torch.from_numpy(reg).permute(0, 3, 1, 2)], torch.from_numpy(sizes), tcfg.MODEL.RPN,
        is_train=is_train, **tkw)
    post = 300 if is_train else 150
    assert tb.shape == (2, post + (4 if is_train else 0), 4) and tuple(jb.shape) == tuple(tb.shape)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.sum() > 0
    _close(ts, js, 1e-5)
    _close(tb, jb, 1e-4)


@pytest.mark.parametrize("dilation", [1, 2])
def test_res5_head_matches_jax(dilation):
    jcfg, tcfg = _c4_configs("e2e_faster_rcnn_R_50_C4_1x.yaml")
    for c in (jcfg, tcfg):
        c.MODEL.ROI_BOX_HEAD.DILATION = dilation
    hc = make_res5_head_config(jcfg)
    params = _redraw(jax.tree.map(np.asarray, init_res5_head(jax.random.PRNGKey(2), hc)),
                     np.random.RandomState(3))
    head = ResNetHead(tcfg)
    head.load_state_dict(params_from_jax(params), strict=True)
    assert (head.layer4[0].conv1.stride, head.layer4[0].conv2.dilation) == (
        (2, 2) if dilation == 1 else (1, 1), (dilation, dilation))
    x = np.random.RandomState(4).randn(5, 14, 14, 256).astype(np.float32)
    want = jax.jit(lambda p, a: apply_res5_head(p, a, hc, jnp.float32))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    with torch.no_grad():
        got = head(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (5, 512, 14 // (3 - dilation), 14 // (3 - dilation))
    _close(got.permute(0, 2, 3, 1).numpy(), want, 1e-4)


# -- C4 Faster and Mask R-CNN ---------------------------------------------------------


@pytest.fixture(scope="module", params=["e2e_faster_rcnn_R_50_C4_1x.yaml",
                                        "e2e_mask_rcnn_R_50_C4_1x.yaml"])
def setup(request):
    jcfg, tcfg = _c4_configs(request.param)
    mask = tcfg.MODEL.MASK_ON
    assert tcfg.MODEL.BACKBONE.CONV_BODY == "R-50-C4"
    assert tcfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO == 0
    assert not mask or tcfg.MODEL.ROI_MASK_HEAD.SHARE_BOX_FEATURE_EXTRACTOR
    jm = build_jax_model(jcfg)
    params = numpy_params(jm)
    assert not mask or set(params["roi_heads"]["mask"]) == {"predictor"}
    tm = GeneralizedRCNN(tcfg)
    tm.load_state_dict(params_from_jax(params), strict=True)
    nb = train_batch(h=HW[0], w=HW[1])
    if mask:
        # 8 x 8 blocks: the 14 x 14 targets of a gt box used as a proposal
        # sample its 112 x 112 patch between pixels 8i + 3 and 8i + 4, which
        # 4 x 4 blocks would put in two blocks (exact 0.5 targets, which the
        # jitted JAX reference rounds either way)
        g = nb["gt_masks"]
        rs = np.random.RandomState(1)
        blocks = rs.rand(g.shape[0], g.shape[1], g.shape[2] // 8, g.shape[3] // 8) > 0.5
        nb["gt_masks"] = blocks.repeat(8, axis=2).repeat(8, axis=3).astype(np.uint8)
    else:
        del nb["gt_masks"]
    n_props = tcfg.MODEL.RPN.POST_NMS_TOP_N_TRAIN + nb["gt_boxes"].shape[1]
    # one level of 16 x 20 cells, 15 anchors each
    draws = jax_sampler_draws(RNG, nb["images"].shape[0], 16 * 20 * 15, n_props)
    return dict(mask=mask, jm=jm, params=jax.tree.map(jnp.asarray, params), tm=tm.eval(),
                batch=nb, draws=draws)


def test_c4_train_forward_losses_and_gradients_match_jax(setup):
    jm, params, tm = setup["jm"], setup["params"], setup["tm"]
    batch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    names = ["loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg"]
    names += ["loss_mask"] if setup["mask"] else []

    def loss_fn(p):
        losses = jm.train_forward(p, batch, RNG)
        return sum(jax.tree.leaves(losses)), losses

    (_, want_losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tm.zero_grad(set_to_none=True)
    losses = tm.train_forward({k: torch.from_numpy(v) for k, v in setup["batch"].items()},
                              draws={k: torch.from_numpy(v) for k, v in setup["draws"].items()})
    assert list(losses) == names and set(want_losses) == set(names)
    for k in names:
        np.testing.assert_allclose(losses[k].item(), float(want_losses[k]), rtol=1e-5, err_msg=k)
    assert losses["loss_box_reg"] > 0
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
    # layer2-3's convs and shortcuts, the res5 head's, the RPN head's 6,
    # the predictor's 4 (and the mask predictor's 4)
    assert trainable == (4 * 3 + 1) + (6 * 3 + 1) + (3 * 3 + 1) + 6 + 4 + (
        4 if setup["mask"] else 0)


def test_c4_infer_forward_matches_jax(setup):
    jm, params, tm = setup["jm"], setup["params"], setup["tm"]
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (2,) + HW + (3,)).astype(np.uint8)
    sizes = np.array([list(HW), [224, 300]], np.int32)
    want = jax.jit(jm.infer_forward)(params, {"images": jnp.asarray(images),
                                              "image_sizes": jnp.asarray(sizes)})
    got = tm.infer_forward({"images": torch.from_numpy(images),
                            "image_sizes": torch.from_numpy(sizes)})
    keys = {"boxes", "scores", "labels", "valid"} | ({"masks"} if setup["mask"] else set())
    assert set(got) == set(want) == keys
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert want["valid"].sum() >= 8
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    if setup["mask"]:
        assert got["masks"].shape[-2:] == (14, 14)
        np.testing.assert_allclose(got["masks"], want["masks"], rtol=1e-4, atol=1e-4)


# -- NMS at the C4 training lane -----------------------------------------------------


def test_plain_nms_on_a_12000_box_lane_matches_jax():
    """A C4 training lane: min(PRE_NMS_TOP_N_TRAIN 12000, 50 * 84 * 15)
    boxes at 800 x 1333."""
    rs = np.random.RandomState(12)
    n = 12000
    boxes = random_boxes(rs, n, 0, 1300, 4, 400)[None]
    scores = (np.round(rs.uniform(size=(1, n)) * 4096) / 4096).astype(np.float32)
    valid = rs.uniform(size=(1, n)) > 0.05
    want = np.asarray(jax.jit(lambda b, s, v: batched_nms_mask(b, s, v, 0.7))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid)))
    got = batched_nms_plain(torch.from_numpy(boxes), torch.from_numpy(scores),
                            torch.from_numpy(valid), 0.7).numpy()
    np.testing.assert_array_equal(got, want)
    assert 1000 < got.sum() < valid.sum()
