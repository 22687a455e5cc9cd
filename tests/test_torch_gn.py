"""The port's group-norm models against the JAX package's, on the CPU:
``group_norm``, a GN bottleneck, the GN stem and bottlenecks, the FPN with
GN and ReLU, the Xconv1fc box head with and without GN, and two GN Mask
R-CNN files from configs/gn_baselines/ (the 1x file, whose box head is
Xconv1fc with GN, and the scratch_ file, whose GN stem and layer1 train at
FREEZE_CONV_BODY_AT 0) at the narrow widths of torch_port_fixtures, the
JAX init (numpy_params) with the group norms at scale U(0.5, 1.5) and bias
U(-0.2, 0.2). Two groups: the narrow widths then keep 8-64 channels a
group, as the published widths do (256 / 32 at the FPN and the heads).

Tolerances: group_norm in float32 1e-5, its gradients 2e-4 of their max;
in bfloat16 (both sides normalise in float32 and round once) 1e-2 of the
largest value; a GN bottleneck and the Xconv head: gradients 2e-4 of their
max; body and FPN features rtol = atol = 1e-4 (the convolutions sum in
other orders); detections: labels and validity exact, scores 1e-5, boxes
1e-3 px, masks 1e-4; losses rtol 1e-5. The GN models' gradients: 2e-3 of
their max, the float32 reproducibility of the reference itself on these
models: the JAX package's jitted gradient of the 1x file differs from its
own eager (op by op) gradient by up to 1.06e-3 of a tensor's max, the
port's from the jitted one by up to 1.5e-3 (the scratch file's layer1);
each module alone agrees to 2e-6 given the same inputs.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskrcnn_tpu.config import cfg as jax_defaults
from maskrcnn_tpu.models import build_detection_model as build_jax_model
from maskrcnn_tpu.models import layers as jl
from maskrcnn_tpu.models.fpn import apply_fpn, init_fpn
from maskrcnn_tpu.models.resnet import ResNetConfig, apply_bottleneck, apply_resnet, init_bottleneck
from maskrcnn_tpu.models.roi_heads import box_head as jbh
from maskrcnn_tpu_torch.config import cfg as torch_defaults
from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN
from maskrcnn_tpu_torch.models.fpn import FPN
from maskrcnn_tpu_torch.models.layers import group_norm
from maskrcnn_tpu_torch.models.resnet import Bottleneck
from maskrcnn_tpu_torch.models.roi_heads.box_head import FPNXconv1fcFeatureExtractor
from maskrcnn_tpu_torch.utils.convert import params_from_jax
from test_models import tiny
from torch_port_fixtures import jax_sampler_draws, narrow, numpy_params, numpy_tree, train_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg",
          "loss_mask")
RNG = jax.random.PRNGKey(5)
GROUPS = 2


def _gn_configs(name):
    jcfg, tcfg = jax_defaults.clone(), torch_defaults.clone()
    for c in (jcfg, tcfg):
        c.merge_from_file(os.path.join(REPO, "configs", "gn_baselines", name))
        narrow(tiny(c))
        c.MODEL.WEIGHT = ""
        c.MODEL.GROUP_NORM.NUM_GROUPS = GROUPS
        c.MODEL.ROI_BOX_HEAD.CONV_HEAD_DIM = 32
    return jcfg, tcfg


def _spread_gn(tree, rs):
    """Group norms of a numpy tree at scale U(0.5, 1.5), bias U(-0.2, 0.2)."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias"}:
            c = tree["scale"].shape[0]
            return {"scale": rs.uniform(0.5, 1.5, c).astype(np.float32),
                    "bias": rs.uniform(-0.2, 0.2, c).astype(np.float32)}
        return {k: _spread_gn(v, rs) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spread_gn(v, rs) for v in tree]
    return tree


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


# -- group_norm --------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 12, 10, 32), (6, 7, 7, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_jax(shape, dtype):
    rs = np.random.RandomState(0)
    x = (rs.randn(*shape) * 3 + 1).astype(np.float32)
    scale = rs.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    bias = rs.uniform(-0.5, 0.5, shape[-1]).astype(np.float32)
    cot = rs.randn(*shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def f(x_, s_, b_):
        out = jl.group_norm(x_.astype(jdt), {"scale": s_, "bias": b_}, GROUPS)
        return out, (out.astype(jnp.float32) * cot).sum()

    want, _ = jax.jit(f)(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    grads = jax.jit(jax.grad(lambda *a: f(*a)[1], argnums=(0, 1, 2)))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    tx = _nchw(x).to(tdt).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    tb = torch.from_numpy(bias).requires_grad_()
    got = group_norm(tx, ts, tb, GROUPS)
    assert got.dtype == tdt and got.shape == tx.shape
    (got.float() * _nchw(cot)).sum().backward()
    got_nhwc = got.detach().float().permute(0, 2, 3, 1).numpy()
    want = np.asarray(want.astype(jnp.float32))
    tgrads = (tx.grad.float().permute(0, 2, 3, 1).numpy(), ts.grad.numpy(), tb.grad.numpy())
    if dtype == "float32":
        _close(got_nhwc, want, 1e-5)
        for g, w in zip(tgrads, grads):
            w = np.asarray(w, np.float32)
            assert np.abs(g - w).max() <= 2e-4 * np.abs(w).max()
    else:
        assert np.abs(got_nhwc - want).max() <= 1e-2 * np.abs(want).max()
        for g, w in zip(tgrads, grads):
            w = np.asarray(w, np.float32)
            assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max()


# -- body, FPN, Xconv head ----------------------------------------------------------


def test_gn_stem_and_bottlenecks_match_jax():
    """The scratch_ file's body (GN stem, BottleneckWithGN, stride in the
    3x3) against apply_resnet."""
    jcfg, tcfg = _gn_configs("scratch_e2e_mask_rcnn_R_50_FPN_3x_gn.yaml")
    jm = build_jax_model(jcfg)
    tree = _spread_gn(numpy_tree(jm, seed=1), np.random.RandomState(2))
    tm = GeneralizedRCNN(tcfg)
    tm.load_state_dict(params_from_jax(tree), strict=True)
    x = np.random.RandomState(3).randn(2, 64, 96, 3).astype(np.float32)
    want = jax.jit(lambda p, a: apply_resnet(p, a, ResNetConfig(jcfg), jnp.float32))(
        jax.tree.map(jnp.asarray, tree["backbone"]["body"]), jnp.asarray(x))
    with torch.no_grad():
        got = tm.backbone.body(_nchw(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1).numpy(), w, 1e-4)
    assert all(p.requires_grad for p in tm.backbone.body.parameters())


@pytest.mark.parametrize("cin,stride", [(64, 1), (64, 2), (128, 1)])
def test_gn_bottleneck_gradients_match_jax(cin, stride):
    """BottleneckWithGN (stride in the 3x3, a shortcut where the widths
    differ) against apply_bottleneck: output, input gradient and every
    parameter's gradient."""
    cout, bott = 128, 32
    p = _spread_gn(jax.tree.map(np.asarray, init_bottleneck(
        jax.random.PRNGKey(cin + stride), cin, bott, cout, 1, "gn")), np.random.RandomState(1))
    rs = np.random.RandomState(2)
    x = np.maximum(rs.randn(2, 16, 20, cin), 0).astype(np.float32)
    cot = rs.randn(2, 16 // stride, 20 // stride, cout).astype(np.float32)

    def f(pp, a):
        out = apply_bottleneck(pp, a, stride, 1, 1, False, "gn", GROUPS, jnp.float32)
        return (out * cot).sum(), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    blk = Bottleneck(cin, bott, cout, stride, 1, 1, False, "gn", GROUPS)
    blk.load_state_dict(params_from_jax(p), strict=True)
    assert (blk.downsample is None) == (cin == cout)
    tx = _nchw(x).contiguous(memory_format=torch.channels_last).requires_grad_()
    got = blk(tx)
    (got * _nchw(cot)).sum().backward()
    _close(got.detach().permute(0, 2, 3, 1).numpy(), want, 1e-4)
    g = params_from_jax(jax.tree.map(np.asarray, gp))
    pairs = [(q.grad, g[n]) for n, q in blk.named_parameters()]
    pairs.append((tx.grad.permute(0, 2, 3, 1), torch.from_numpy(np.array(gx))))
    for a, w in pairs:
        assert (a - w).abs().max() <= 2e-4 * w.abs().max()


@pytest.mark.parametrize("use_gn,use_relu", [(True, False), (True, True), (False, True)])
def test_fpn_with_gn_and_relu_matches_jax(use_gn, use_relu):
    in_channels = [16, 32, 64, 128]
    params = jax.tree.map(np.asarray, init_fpn(jax.random.PRNGKey(0), in_channels, 32, use_gn))
    params = _spread_gn(params, np.random.RandomState(1))
    rs = np.random.RandomState(2)
    feats = [rs.randn(2, 32 >> i, 40 >> i, c).astype(np.float32)
             for i, c in enumerate(in_channels)]
    want = jax.jit(lambda p, f: apply_fpn(p, f, use_gn, use_relu, GROUPS, top_block="maxpool",
                                          compute_dtype=jnp.float32))(
        jax.tree.map(jnp.asarray, params), [jnp.asarray(f) for f in feats])
    fpn = FPN(in_channels, 32, gn_groups=GROUPS if use_gn else 0, relu=use_relu)
    fpn.load_state_dict(params_from_jax(params), strict=True)
    assert all((blk.conv.bias is None) == use_gn for blk in list(fpn.inner) + list(fpn.layer))
    with torch.no_grad():
        got = fpn([_nchw(f) for f in feats])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1).numpy(), w, 1e-4)
    if use_relu:
        assert all(float(g.min()) >= 0 for g in got)


@pytest.mark.parametrize("use_gn", [True, False])
def test_xconv1fc_extractor_matches_jax(use_gn):
    """FPNXconv1fcFeatureExtractor, forward and the gradients of its input
    and parameters (fc6 takes the (P, P, C) flatten)."""
    jcfg, tcfg = _gn_configs("e2e_mask_rcnn_R_50_FPN_Xconv1fc_1x_gn.yaml")
    for c in (jcfg, tcfg):
        c.MODEL.ROI_BOX_HEAD.USE_GN = use_gn
    params = jax.tree.map(np.asarray, jbh.init_box_feature_extractor(
        jax.random.PRNGKey(1), jcfg, 32)[0])
    params = _spread_gn(params, np.random.RandomState(3))
    rs = np.random.RandomState(4)
    pooled = rs.randn(10, 7, 7, 32).astype(np.float32)
    cot = rs.randn(10, 64).astype(np.float32)

    def f(p, x):
        out = jbh.apply_box_feature_extractor(p, x, jcfg, jnp.float32)
        return (out * cot).sum(), out

    (_, want), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pooled))
    head = FPNXconv1fcFeatureExtractor(tcfg, 32)
    head.load_state_dict(params_from_jax(params), strict=True)
    assert len(head.convs) == 4 and all((b.gn is not None) == use_gn for b in head.convs)
    x = torch.from_numpy(pooled).requires_grad_()
    got = head(x)
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got.detach().numpy(), want, 1e-4)
    want_grads = params_from_jax(jax.tree.map(np.asarray, grads[0]))
    pairs = [(p.grad, want_grads[n]) for n, p in head.named_parameters()]
    pairs.append((x.grad, torch.from_numpy(np.array(grads[1]))))
    assert len(pairs) == (15 if use_gn else 11)
    for g, w in pairs:
        assert (g - w).abs().max() <= 2e-4 * w.abs().max()


# -- GN Mask R-CNN -------------------------------------------------------------------


@pytest.fixture(scope="module", params=["e2e_mask_rcnn_R_50_FPN_1x_gn.yaml",
                                        "scratch_e2e_mask_rcnn_R_50_FPN_3x_gn.yaml"])
def setup(request):
    jcfg, tcfg = _gn_configs(request.param)
    assert tcfg.MODEL.RESNETS.TRANS_FUNC == "BottleneckWithGN" and tcfg.MODEL.FPN.USE_GN
    assert tcfg.MODEL.MASK_ON and tcfg.MODEL.ROI_MASK_HEAD.USE_GN
    jm = build_jax_model(jcfg)
    tree = _spread_gn(numpy_params(jm), np.random.RandomState(6))
    tm = GeneralizedRCNN(tcfg)
    tm.load_state_dict(params_from_jax(tree), strict=True)
    nb = train_batch()
    n_props = tcfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN + nb["gt_boxes"].shape[1]
    # anchors of a 128 x 160 batch: (32*40 + 16*20 + 8*10 + 4*5 + 2*3) * 3
    draws = jax_sampler_draws(RNG, nb["images"].shape[0], 5118, n_props)
    return dict(name=request.param, jm=jm, params=jax.tree.map(jnp.asarray, tree),
                tm=tm.eval(), batch=nb, draws=draws,
                frozen_at=tcfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT,
                xconv=tcfg.MODEL.ROI_BOX_HEAD.FEATURE_EXTRACTOR == "FPNXconv1fcFeatureExtractor")


def test_gn_train_forward_losses_and_gradients_match_jax(setup):
    jm, params, tm = setup["jm"], setup["params"], setup["tm"]
    batch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}

    def loss_fn(p):
        losses = jm.train_forward(p, batch, RNG)
        return sum(jax.tree.leaves(losses)), losses

    (_, want_losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    tm.zero_grad(set_to_none=True)
    losses = tm.train_forward({k: torch.from_numpy(v) for k, v in setup["batch"].items()},
                              draws={k: torch.from_numpy(v) for k, v in setup["draws"].items()})
    assert tuple(losses) == LOSSES and set(want_losses) == set(LOSSES)
    for k in LOSSES:
        np.testing.assert_allclose(losses[k].item(), float(want_losses[k]), rtol=1e-5, err_msg=k)
    assert losses["loss_box_reg"] > 0 and losses["loss_mask"] > 0
    sum(losses.values()).backward()
    want = params_from_jax(jax.tree.map(np.asarray, grads))
    frozen = ("backbone.body.stem.", "backbone.body.layer1.") if setup["frozen_at"] == 2 else ()
    trainable = gn = 0
    for name, p in tm.named_parameters():
        if name.startswith(frozen) and frozen:
            assert not p.requires_grad and p.grad is None, name
            continue
        assert p.requires_grad, name
        trainable += 1
        gn += name.endswith(".scale")
        scale = want[name].abs().max().item()
        err = (p.grad - want[name]).abs().max().item()
        assert err <= 2e-3 * scale, (name, err, scale)
    # group norms: 4 FPN levels x 2; the body's 3 a block, the shortcuts',
    # the stem's (only in the scratch file's trainable stem and layer1);
    # the Xconv head's 4
    body = 3 * (4 + 6 + 3) + 3 + (3 * 3 + 1 + 1 if not frozen else 0)
    xconv = 4 if setup["xconv"] else 0
    assert gn == 8 + body + xconv
    assert trainable > gn


def test_gn_infer_forward_matches_jax(setup):
    jm, params, tm = setup["jm"], setup["params"], setup["tm"]
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
    assert want["valid"].sum() >= 8
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["masks"], want["masks"], rtol=1e-4, atol=1e-4)
