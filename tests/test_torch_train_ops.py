"""The port's training modules against the JAX package's, one by one.

Both sides run in float32 on the CPU with the same numpy inputs (and, for
the samplers, the same uniform draws: the ones JAX makes from its key).
Tolerances: the anchor matcher, the samplers, the box targets' indices and
labels, and the positive selection exact; box encoding and losses 1e-6
(the same float32 operations, rounded alike but for log/exp ulps); the
pooler's gradient rtol 1e-5 (the scatter sums its terms in another order);
the mask head's gt-class logits 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskrcnn_tpu.models.anchors import make_anchor_generator as jax_anchor_generator
from maskrcnn_tpu.models.detector import _compact_positives as jax_compact_positives
from maskrcnn_tpu.models.poolers import PoolerConfig as JaxPoolerConfig
from maskrcnn_tpu.models.poolers import multilevel_roi_align as jax_roi_align
from maskrcnn_tpu.models.resnet import ResNetConfig
from maskrcnn_tpu.models.roi_heads import box_head as jbh
from maskrcnn_tpu.models.roi_heads import mask_head as jmh
from maskrcnn_tpu.models.rpn import make_rpn_cfg
from maskrcnn_tpu.models.rpn import rpn_loss as jax_rpn_loss
from maskrcnn_tpu.models.rpn import select_proposals as jax_select_proposals
from maskrcnn_tpu.ops import box_ops as jbox
from maskrcnn_tpu.ops import losses as jlosses
from maskrcnn_tpu.ops import matcher as jmatcher
from maskrcnn_tpu.ops.pallas.matcher_kernel import CHUNK, match_anchors_pallas
from maskrcnn_tpu.ops.sampler import sample_topk_indices as jax_sample
from maskrcnn_tpu_torch.models.anchors import make_anchor_generator
from maskrcnn_tpu_torch.models.detector import _compact_positives
from maskrcnn_tpu_torch.models.poolers import PoolerConfig, multilevel_roi_align
from maskrcnn_tpu_torch.models.resnet import ResNet
from maskrcnn_tpu_torch.models.roi_heads import box_head as tbh
from maskrcnn_tpu_torch.models.roi_heads import mask_head as tmh
from maskrcnn_tpu_torch.models.rpn import rpn_loss, select_proposals
from maskrcnn_tpu_torch.ops import box_ops as tbox
from maskrcnn_tpu_torch.ops import losses as tlosses
from maskrcnn_tpu_torch.ops.matcher import (
    match_anchors_batched,
    match_anchors_plain,
    match_proposals,
)
from maskrcnn_tpu_torch.ops.sampler import sample_topk_indices
from maskrcnn_tpu_torch.utils.convert import params_from_jax
from test_pallas_matcher import _rand_problem
from torch_port_fixtures import configs, model_pair, random_boxes

SCALES = (0.25, 0.125, 0.0625, 0.03125)
T = torch.from_numpy


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _draws(key, n):
    """What sample_topk_indices draws from `key` for n candidates."""
    kp, kn = jax.random.split(key)
    return np.asarray(jax.random.uniform(kp, (n,))), np.asarray(jax.random.uniform(kn, (n,)))


def _batch_draws(rng, b, n):
    draws = [_draws(k, n) for k in jax.random.split(rng, b)]
    return T(np.stack([d[0] for d in draws])), T(np.stack([d[1] for d in draws]))


# -- 1. box encoding, 2. losses ------------------------------------------------------


def test_encode_boxes_matches_jax():
    rs = np.random.RandomState(0)
    gt = random_boxes(rs, 300, 0, 500, 1, 300)
    props = random_boxes(rs, 300, 0, 500, 0.5, 300)
    props[:3] = [[10, 10, 5, 5], [0, 0, 0, 0], [20, 30, 20, 30]]  # degenerate and padded
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        want = jbox.encode_boxes(jnp.asarray(gt), jnp.asarray(props), w)
        _close(tbox.encode_boxes(T(gt), T(props), w).numpy(), want, 1e-6)


def test_losses_match_jax():
    rs = np.random.RandomState(1)
    x = (rs.randn(64, 81) * 3).astype(np.float32)
    y = (rs.randn(64, 81) * 3).astype(np.float32)
    labels = rs.randint(-1, 81, 64).astype(np.int32)
    mask = rs.rand(64) > 0.3
    for beta in (1.0, 1.0 / 9):
        _close(tlosses.smooth_l1_loss(T(x), T(y), beta).numpy(),
               jlosses.smooth_l1_loss(jnp.asarray(x), jnp.asarray(y), beta), 1e-6)
    _close(tlosses.softmax_cross_entropy(T(x), T(labels), T(mask)).numpy(),
           jlosses.softmax_cross_entropy(jnp.asarray(x), jnp.asarray(labels), jnp.asarray(mask)),
           1e-6)
    t = (rs.rand(64, 81) > 0.5).astype(np.float32)
    _close(tlosses.binary_cross_entropy_with_logits(T(x), T(t)).numpy(),
           jlosses.binary_cross_entropy_with_logits(jnp.asarray(x), jnp.asarray(t)), 1e-6)


# -- 3. matchers ------------------------------------------------------------------------


def _low_quality_problem():
    """A gt whose best anchor IoU (< 0.3) is reached by two anchors, one of
    them matched better elsewhere, and a gt best matched at 0.7 exactly."""
    anchors = np.array(
        [[0, 0, 10, 10], [100, 100, 140, 140], [200, 200, 210, 210], [200, 200, 210, 210],
         [150, 150, 165, 165]] + [[300 + i, 300, 310 + i, 312] for i in range(5)],
        np.float32)
    anchors = np.concatenate([anchors, np.zeros((CHUNK + 40 - len(anchors), 4), np.float32)])
    gt = np.array([[[101, 101, 139, 139], [190, 190, 235, 235], [0, 0, 200, 200],
                    [300, 300, 309, 312]],
                   [[0, 0, 0, 0]] * 4], np.float32)
    gv = np.array([[True, True, True, True], [False] * 4])
    return anchors, gt, gv


@pytest.mark.parametrize("problem", ["hole", "no_gt_image", "low_quality"])
def test_anchor_matcher_plain_matches_jax_exactly(problem):
    if problem == "low_quality":
        anchors, gt, gv = _low_quality_problem()
    else:
        anchors, gt, gv = (np.asarray(a) for a in _rand_problem(
            0, CHUNK + 700, b=2, g=12, zero_image=problem == "no_gt_image"))
    streaming = jax.vmap(lambda g_, v_: jmatcher.match_anchors_streaming(
        jnp.asarray(anchors), g_, v_, 0.7, 0.3))(jnp.asarray(gt), jnp.asarray(gv))
    pallas = match_anchors_pallas(jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(gv),
                                  0.7, 0.3, interpret=True)
    got = match_anchors_plain(T(anchors), T(gt), T(gv), 0.7, 0.3)
    assert got.dtype == torch.int32 and got.shape == (2, len(anchors))
    np.testing.assert_array_equal(got.numpy(), np.asarray(streaming))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    assert (got.numpy() >= 0).any() and (got.numpy() == -2).any() or problem == "low_quality"
    if problem == "low_quality":
        # anchors 2 and 3 tie gt 1's best IoU below the low threshold
        assert got[0, 2] == got[0, 3] == 1 and got[0, 4] == -1
    if problem == "no_gt_image":
        assert (got[1] == -1).all()


def test_anchor_matcher_wrapper_runs_plain_version_on_cpu():
    anchors, gt, gv = (T(np.asarray(a)) for a in _rand_problem(1, 3000, b=2, g=7))
    before = match_anchors_batched.launches
    got = match_anchors_batched(anchors, gt, gv, 0.7, 0.3)
    assert match_anchors_batched.launches == before
    assert torch.equal(got, match_anchors_plain(anchors, gt, gv, 0.7, 0.3))
    with pytest.raises(ValueError):
        match_anchors_batched(anchors, gt, gv[:, :3], 0.7, 0.3)


@pytest.mark.parametrize("low_quality", [False, True])
def test_match_proposals_matches_jax(low_quality):
    rs = np.random.RandomState(2)
    gt = random_boxes(rs, 10, 0, 200, 10, 80)
    props = np.concatenate([gt + rs.uniform(-4, 4, gt.shape).astype(np.float32),
                            random_boxes(rs, 200, 0, 200, 5, 100)])
    gv = np.arange(10) < 8
    gv[2] = False
    iou = np.asarray(jbox.box_iou(jnp.asarray(gt), jnp.asarray(props)))
    want = jmatcher.match_proposals(jnp.asarray(iou), jnp.asarray(gv), 0.5, 0.5, low_quality)
    got = match_proposals(T(iou), T(gv), 0.5, 0.5, low_quality)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- 4. sampler ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,bs,frac,p_pos", [
    (5000, 256, 0.5, 0.002),   # fewer positives than the quota
    (5000, 256, 0.5, 0.3),     # the quota binds
    (20000, 256, 0.5, 0.01),   # above the JAX package's approximate top-k size
    (2100, 512, 0.25, 0.02),   # the box head's sampler
    (300, 512, 0.25, 0.05),    # fewer candidates than the batch
])
def test_sampler_matches_jax_with_its_draws(n, bs, frac, p_pos):
    rs = np.random.RandomState(n)
    labels = np.where(rs.rand(n) < p_pos, rs.randint(1, 81, n),
                      np.where(rs.rand(n) < 0.8, 0, -1)).astype(np.int32)
    key = jax.random.PRNGKey(n)
    want = jax_sample(jnp.asarray(labels), key, bs, frac)
    pos, neg = _draws(key, n)
    got = sample_topk_indices(T(labels)[None], T(pos)[None], T(neg)[None], bs, frac)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


# -- 5. anchors, 6. RPN ---------------------------------------------------------------------


def test_visibility_matches_jax():
    jcfg, tcfg = configs()
    ja, ta = jax_anchor_generator(jcfg), make_anchor_generator(tcfg)
    anchors = np.concatenate([np.asarray(ja.grid_anchors_level(l, 16 >> l, 20 >> l))
                              for l in range(3)])
    sizes = np.array([[64, 80], [50, 61]], np.float32)
    want = jax.vmap(lambda h, w: ja.visibility(jnp.asarray(anchors), h, w))(
        jnp.asarray(sizes[:, 0]), jnp.asarray(sizes[:, 1]))
    got = ta.visibility(T(anchors), T(sizes[:, :1]), T(sizes[:, 1:]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got.all() and got.any()


def _rpn_inputs(seed=6):
    shapes = ((32, 40), (16, 20), (8, 10), (4, 5), (2, 3))
    rs = np.random.RandomState(seed)
    obj = [(rs.randn(2, h, w, 3) * 2).astype(np.float32) for h, w in shapes]
    reg = [(rs.randn(2, h, w, 12) * 0.3).astype(np.float32) for h, w in shapes]
    sizes = np.array([[128, 160], [100, 150]], np.int32)
    gt = np.stack([random_boxes(rs, 5, 20, 120, 10, 80) for _ in range(2)])
    gv = np.array([[True, True, False, True, False], [True] * 5])
    ja = jax_anchor_generator(configs()[0])
    anchors = [np.asarray(ja.grid_anchors_level(l, h, w)) for l, (h, w) in enumerate(shapes)]
    return anchors, obj, reg, sizes, gt, gv


def _nchw(x):
    return T(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_training_proposals_match_jax():
    jcfg, tcfg = configs()
    for c in (jcfg, tcfg):
        c.MODEL.RPN.PRE_NMS_TOP_N_TRAIN = 200
        c.MODEL.RPN.POST_NMS_TOP_N_TRAIN = 100
        c.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN = 150  # over the batch: binds per image
    anchors, obj, reg, sizes, gt, gv = _rpn_inputs()
    rpn_cfg = make_rpn_cfg(jcfg)
    jb, js, jv = jax.jit(lambda a, o, r, s, g, v: jax_select_proposals(
        a, o, r, s, rpn_cfg, True, gt_boxes=g, gt_valid=v))(
        [jnp.asarray(a) for a in anchors], [jnp.asarray(o) for o in obj],
        [jnp.asarray(r) for r in reg], jnp.asarray(sizes), jnp.asarray(gt), jnp.asarray(gv))
    tb, ts, tv = select_proposals(
        [T(a) for a in anchors], [_nchw(o) for o in obj], [_nchw(r) for r in reg],
        T(sizes), tcfg.MODEL.RPN, is_train=True, gt_boxes=T(gt), gt_valid=T(gv))
    assert tb.shape == (2, 150 + 5, 4)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert 0 < int(tv[:, :150].sum()) <= 150  # the batch-wide cap
    _close(tb[:, 150:].numpy(), gt, 0)
    for i in range(2):  # the top-k leaves tied scores' order open: sorted sets
        v = np.asarray(jv[i])
        want = np.concatenate([np.asarray(js[i])[v, None], np.asarray(jb[i])[v]], 1)
        got = np.concatenate([ts[i].numpy()[v, None], tb[i].numpy()[v]], 1)
        _close(got[np.lexsort(got.T[::-1])], want[np.lexsort(want.T[::-1])], 1e-5)


def test_rpn_loss_matches_jax():
    anchors, obj, reg, sizes, gt, gv = _rpn_inputs(7)
    cat = np.concatenate(anchors)
    n = len(cat)
    rs = np.random.RandomState(8)
    visible = rs.rand(2, n) > 0.1
    o = np.concatenate([x.reshape(2, -1) for x in obj], 1)
    r = np.concatenate([x.reshape(2, -1, 4) for x in reg], 1)
    rng = jax.random.PRNGKey(9)
    want = jax_rpn_loss(jnp.asarray(cat), jnp.asarray(visible), jnp.asarray(o), jnp.asarray(r),
                        jnp.asarray(gt), jnp.asarray(gv), rng, 0.7, 0.3, 256, 0.5)
    pos, neg = _batch_draws(rng, 2, n)
    got = rpn_loss(T(cat), T(visible), T(o), T(r), T(gt), T(gv), pos, neg, 0.7, 0.3, 256, 0.5)
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-6)


# -- 7. pooler gradient --------------------------------------------------------------------


@pytest.mark.parametrize("p", [7, 14])
def test_pooler_gradient_matches_jax_grad(p):
    rs = np.random.RandomState(p)
    feats = [rs.randn(2, 64 >> i, 80 >> i, 16).astype(np.float32) for i in range(4)]
    boxes = random_boxes(rs, 40, -40, 300, 0.2, 260)
    boxes[:3] = [[-500, -500, -400, -400], [300, 10, 420, 50], [5, 5, 5, 5]]  # outside, edge
    bidx = rs.randint(0, 2, 40).astype(np.int32)
    dout = rs.randn(40, p, p, 16).astype(np.float32)

    def jax_fn(fs):
        out = jax_roi_align(list(fs), jnp.asarray(boxes), jnp.asarray(bidx),
                            JaxPoolerConfig(p, SCALES, 2), compute_dtype=jnp.float32,
                            backend="gather")
        return jnp.sum(out * jnp.asarray(dout))

    want = jax.grad(jax_fn)(tuple(jnp.asarray(f) for f in feats))
    tf = [T(f).requires_grad_() for f in feats]
    out = multilevel_roi_align(tf, T(boxes), T(bidx), PoolerConfig(p, SCALES, 2))
    (out * T(dout)).sum().backward()
    for f, w in zip(tf, want):
        np.testing.assert_allclose(f.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    assert any(float(np.abs(np.asarray(w)).max()) > 0 for w in want)


# -- 8. box head ------------------------------------------------------------------------------


def _box_problem(seed=10):
    rs = np.random.RandomState(seed)
    gt = np.stack([random_boxes(rs, 6, 20, 200, 10, 90) for _ in range(2)])
    labels = rs.randint(1, 81, (2, 6)).astype(np.int32)
    labels[1, 3:] = 0
    labels[0, 1] = 0
    props = np.concatenate([
        np.stack([random_boxes(rs, 300, 0, 220, 4, 120) for _ in range(2)]),
        gt + rs.uniform(-5, 5, gt.shape).astype(np.float32), gt], 1)
    pvalid = rs.rand(2, props.shape[1]) > 0.1
    pvalid[:, -6:] = labels > 0
    return props, pvalid, gt, labels


def test_box_targets_and_loss_match_jax():
    props, pvalid, gt, labels = _box_problem()
    rng = jax.random.PRNGKey(11)
    w = (10.0, 10.0, 5.0, 5.0)
    want = jbh.prepare_box_targets(jnp.asarray(props), jnp.asarray(pvalid), jnp.asarray(gt),
                                   jnp.asarray(labels), rng, 0.5, 0.5, 128, 0.25, w)
    pos, neg = _batch_draws(rng, 2, props.shape[1])
    got = tbh.prepare_box_targets(T(props), T(pvalid), T(gt), T(labels), pos, neg,
                                  0.5, 0.5, 128, 0.25, w)
    for k in ("rois", "labels", "valid", "is_pos", "matched_gt_idx"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    _close(got["reg_targets"].numpy(), want["reg_targets"], 1e-5)
    assert got["is_pos"].any() and (got["valid"] & ~got["is_pos"]).any()

    rs = np.random.RandomState(12)
    logits = rs.randn(256, 81).astype(np.float32)
    reg = (rs.randn(256, 324) * 0.1).astype(np.float32)
    for agnostic in (False, True):
        r = reg[:, :8] if agnostic else reg
        want_l = jbh.box_head_loss(jnp.asarray(logits), jnp.asarray(r), want,
                                   cls_agnostic=agnostic)
        got_l = tbh.box_head_loss(T(logits), T(r), got, cls_agnostic=agnostic)
        for g_, w_ in zip(got_l, want_l):
            _close(g_.numpy(), w_, 1e-6)


# -- 9. mask head ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    return model_pair()


def test_mask_head_training_pieces_match_jax(pair):
    jm, params, tm = pair
    jcfg, _ = configs()
    rs = np.random.RandomState(13)
    is_pos = np.zeros((2, 16), bool)
    is_pos[0, :5] = True
    is_pos[1, :2] = True
    targets = {"is_pos": is_pos, "valid": np.ones((2, 16), bool)}
    want_idx, want_valid = jmh.select_positive_rois(
        {k: jnp.asarray(v) for k, v in targets.items()}, 4)
    idx, valid = tmh.select_positive_rois({k: T(v) for k, v in targets.items()}, 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))

    pooled = rs.randn(10, 14, 14, 32).astype(np.float32)
    labels = rs.randint(-1, 81, 10).astype(np.int32)
    pm = params["roi_heads"]["mask"]
    x = jmh.apply_mask_feature_extractor(pm["feature_extractor"], jnp.asarray(pooled), jcfg,
                                         jnp.float32)
    want = jmh.apply_mask_predictor_at_class(pm["predictor"], x, jnp.asarray(labels), jcfg,
                                             jnp.float32)
    with torch.no_grad():
        got = tm.roi_heads.mask.logits_at_class(T(pooled), T(labels))
    assert got.shape == (10, 28, 28) and got.dtype == torch.float32
    _close(got.numpy(), want, 1e-5)

    patches = (rs.rand(10, 112, 112) > 0.5).astype(np.float32)
    gt = random_boxes(rs, 10, 20, 100, 8, 70)
    props = random_boxes(rs, 10, 20, 100, 8, 70)
    props[0] = gt[0]
    tgt = jmh.project_gt_masks(jnp.asarray(patches), jnp.asarray(gt), jnp.asarray(props), 28)
    tgt_t = tmh.project_gt_masks(T(patches), T(gt), T(props), 28)
    _close(tgt_t.numpy(), tgt, 1e-6)
    mvalid = rs.rand(10) > 0.3
    _close(tmh.mask_head_loss_picked(got, tgt_t, T(mvalid)).numpy(),
           jmh.mask_head_loss_picked(want, tgt, jnp.asarray(mvalid)), 1e-6)


def test_compact_positives_matches_jax():
    rs = np.random.RandomState(14)
    r = 64
    state = (random_boxes(rs, r, 0, 100, 5, 50), np.repeat(np.arange(4, dtype=np.int32), 16),
             rs.rand(r) > 0.6, rs.randint(1, 81, r).astype(np.int32),
             rs.randint(0, 8, r).astype(np.int32))
    for cap in (0, 8, 40, 64):
        want = jax_compact_positives(tuple(jnp.asarray(x) for x in state), cap)
        got = _compact_positives(tuple(T(x) for x in state), cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- 11. backbone freezing and remat, 14. the converter on gradients ------------------------------


def test_backbone_freezing_and_remat_rule():
    jcfg, tcfg = configs()
    body = ResNet(tcfg)
    frozen = {n.split(".")[0] for n, p in body.named_parameters() if not p.requires_grad}
    assert frozen == {"stem", "layer1"}
    assert all(p.requires_grad for n, p in body.named_parameters()
               if n.split(".")[0] in ("layer2", "layer3", "layer4"))
    assert not body.remat and ResNetConfig(jcfg).remat == body.remat
    for conv_body in ("R-101-FPN",):
        for c in (jcfg, tcfg):
            c.MODEL.BACKBONE.CONV_BODY = conv_body
        assert ResNet(tcfg).remat and ResNetConfig(jcfg).remat


def test_remat_gives_the_same_gradients():
    _, tcfg = configs()
    tcfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 8
    tcfg.MODEL.RESNETS.WIDTH_PER_GROUP = 4
    tcfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 16
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    grads = []
    for remat in ("off", "on"):
        tcfg.TPU.REMAT_BACKBONE = remat
        body = ResNet(tcfg)
        body.reset_parameters(torch.Generator().manual_seed(1))
        assert body.remat == (remat == "on")
        sum(o.square().sum() for o in body(x)).backward()
        grads.append([p.grad for p in body.parameters() if p.requires_grad])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_params_from_jax_is_linear_on_gradient_trees(pair):
    """The converter's maps (transposes and the deconv flip) are linear, so a
    JAX gradient tree converts like the parameters it belongs to."""
    _, params, tm = pair
    a = jax.tree.map(lambda x: np.random.RandomState(x.size % 97).randn(*x.shape)
                     .astype(np.float32), params)
    b = jax.tree.map(lambda x: np.full(x.shape, 0.5, np.float32), params)
    ca, cb = params_from_jax(a), params_from_jax(b)
    cab = params_from_jax(jax.tree.map(lambda x, y: x + 2 * y, a, b))
    assert set(cab) == set(tm.state_dict())
    for k in cab:
        torch.testing.assert_close(cab[k], ca[k] + 2 * cb[k], rtol=1e-6, atol=1e-6)
        assert cab[k].shape == tm.state_dict()[k].shape
