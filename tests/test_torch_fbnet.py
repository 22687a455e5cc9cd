"""The port's FBNet models against the JAX package's, on the CPU in float32:

* the plans: ``parse_op`` on every primitive name, the five built-in
  architectures' block specs (SCALE_FACTOR and WIDTH_DIVISOR too) and a
  maskrcnn-benchmark ARCH_DEF JSON, plan for plan;
* each of the five architectures' bodies at its published widths;
* every block kind (skip, cascade, shift, the inverted residual with
  expansion override, grouped pointwise convs and shuffle, squeeze-excite,
  cascaded depthwise, stride 2 and the stride -2 upsample), forward and the
  gradients of the input and every weight;
* FBNet.rpn_head, FBNet.roi_head and FBNet.roi_head_mask;
* configs/e2e_mask_rcnn_fbnet.yaml and e2e_faster_rcnn_fbnet_chamv1a_600.yaml
  under test_models.tiny on 128 x 160 images: train_forward's losses and
  every gradient (of the port's convolutions in float64: see the test) on
  JAX's sampler draws, and the detections;
* the FBNET keys that the JAX package reads nowhere (DW_CONV_SKIP_BN,
  DW_CONV_SKIP_RELU, DET_HEAD_LAST_SCALE, BN_TYPE, RPN_BN_TYPE, the
  *_HEAD_BLOCKS and *_HEAD_STRIDE) change nothing in either package
  (ROADMAP.md Queue 3).

The JAX parameters are its init with the frozen BN redrawn
(torch_port_fixtures._redraw, numpy_params), passed through params_from_jax.
Tolerances: forward 1e-5 (bodies and heads relative to the output's largest
value); every gradient within 2e-4 of the JAX gradient's max; losses rtol
1e-5; detections: labels and validity exact, scores 1e-5, boxes 1e-3 px,
masks 1e-4.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskrcnn_tpu.config import cfg as jax_defaults
from maskrcnn_tpu.models import build_detection_model as build_jax_model
from maskrcnn_tpu.models import fbnet as jfb
from maskrcnn_tpu_torch.config import cfg as torch_defaults
from maskrcnn_tpu_torch.models import fbnet as tfb
from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN
from maskrcnn_tpu_torch.utils.convert import params_from_jax
from test_models import tiny
from torch_port_fixtures import one_torch_thread  # noqa: F401
from torch_port_fixtures import _redraw, jax_sampler_draws, numpy_params, train_batch

pytestmark = pytest.mark.usefixtures("one_torch_thread")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = jax.random.PRNGKey(5)
HW = (128, 160)
PRIMITIVES = ["skip", "basic_block", "shift_5x5", "shuffle", "ir_k3", "ir_k5", "ir_k7", "ir_k1",
              "ir_k3_e1", "ir_k3_e3", "ir_k5_e6", "ir_k3_s2", "ir_k5_s4", "ir_k3_se",
              "ir_k5_e4_se", "ir_k33_e6", "ir_k3_sep", "ir_k7_sep_e3", "k3", "k5", "k7"]


def _cfgs(name=None, **fbnet):
    jcfg, tcfg = jax_defaults.clone(), torch_defaults.clone()
    for c in (jcfg, tcfg):
        if name:
            c.merge_from_file(os.path.join(REPO, "configs", name))
            tiny(c)
            c.TPU.COMPUTE_DTYPE = "float32"
        c.MODEL.BACKBONE.CONV_BODY = "FBNet"
        for k, v in fbnet.items():
            setattr(c.MODEL.FBNET, k, v)
    return jcfg, tcfg


def _close_scaled(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


def _grad_close(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= 2e-4 * scale, (name, err, scale)


# -- plans ----------------------------------------------------------------------------


def test_parse_op_matches_jax():
    for name in PRIMITIVES:
        assert tfb.parse_op(name) == jfb.parse_op(name), name
    for bad in ("ir_k3_x2", "conv_k3"):
        with pytest.raises(ValueError):
            tfb.parse_op(bad)
        with pytest.raises(ValueError):
            jfb.parse_op(bad)


def _plan_fields(plan):
    return (plan.first_out, plan.first_stride, plan.trunk_blocks, plan.trunk_out,
            plan.rpn_blocks, plan.bbox_blocks, plan.mask_blocks)


@pytest.mark.parametrize("scale,divisor", [(1.0, 8), (0.5, 8), (0.75, 4)])
def test_builtin_plans_match_jax(scale, divisor):
    assert tfb.MODEL_ARCH == jfb.MODEL_ARCH
    for arch in sorted(tfb.MODEL_ARCH):
        jcfg, tcfg = _cfgs(ARCH=arch, SCALE_FACTOR=scale, WIDTH_DIVISOR=divisor)
        assert _plan_fields(tfb.FBNetPlan(tcfg)) == _plan_fields(jfb.FBNetPlan(jcfg)), arch


def test_reference_arch_def_json_matches_jax():
    """maskrcnn-benchmark's ARCH_DEF schema: one op a block, [t, c, n, s]
    groups, the head stage lists."""
    arch = {"block_op_type": [["ir_k3"], ["ir_k5_e4_se", "skip"], ["ir_k33_e6", "shift_5x5",
                                                                   "basic_block"],
                              ["ir_k3_s2", "shuffle"], ["ir_k7_sep", "ir_k3"], ["ir_k3"]],
            "block_cfg": {"first": [16, 2],
                          "stages": [[[1, 16, 1, 1]], [[4, 24, 2, 2]], [[6, 32, 3, 2]],
                                     [[6, 64, 1, 2], [4, 64, 1, 1]], [[6, 96, 2, 1]],
                                     [[3, 48, 1, -2]]],
                          "backbone": [0, 1, 2, 3], "rpn": [4], "bbox": [4], "mask": [5]}}
    assert tfb.convert_reference_arch_def(arch) == jfb.convert_reference_arch_def(arch)
    jcfg, tcfg = _cfgs(ARCH_DEF=json.dumps(arch), WIDTH_DIVISOR=8)
    tplan, jplan = tfb.FBNetPlan(tcfg), jfb.FBNetPlan(jcfg)
    assert _plan_fields(tplan) == _plan_fields(jplan)
    assert {b["kind"] for b in tplan.trunk_blocks} == {"irf", "skip", "shift", "cascade"}


# -- bodies ------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(tfb.MODEL_ARCH))
def test_fbnet_body_matches_jax(arch):
    jcfg, tcfg = _cfgs(ARCH=arch, WIDTH_DIVISOR=8)
    jb = jfb.build_fbnet_backbone(jcfg)
    params = _redraw(jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(1))),
                     np.random.RandomState(2))
    tb = tfb.FBNetBackbone(tcfg)
    tb.load_state_dict(params_from_jax(params), strict=True)
    assert (tb.out_channels, tb.strides) == (jb.out_channels, jb.strides) == \
        (tb.out_channels, [16])
    x = np.random.RandomState(3).randn(2, 64, 96, 3).astype(np.float32)
    (want,) = jax.jit(lambda p, a: jb.apply(p, a, jnp.float32))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    with torch.no_grad():
        (got,) = tb(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, jb.out_channels, 4, 6)
    _close_scaled(got.permute(0, 2, 3, 1).numpy(), want)


# -- blocks ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,t,cin,c,s", [
    ("skip", 1, 16, 16, 1), ("skip", 1, 16, 24, 2), ("basic_block", 1, 16, 16, 1),
    ("basic_block", 1, 16, 24, 2), ("shift_5x5", 3, 16, 16, 1), ("shift_5x5", 2, 16, 24, 2),
    ("ir_k3", 6, 16, 16, 1), ("ir_k5", 4, 16, 24, 2), ("ir_k3_e1", 6, 16, 16, 1),
    ("ir_k1", 4, 16, 16, 1), ("ir_k3_s2", 6, 16, 16, 1), ("ir_k5_s4", 6, 16, 32, 1),
    ("shuffle", 2, 16, 16, 1), ("ir_k3_se", 4, 16, 16, 1), ("ir_k33_e6", 1, 16, 24, 1),
    ("ir_k7_sep_e3", 1, 16, 16, 2), ("ir_k3", 3, 16, 8, -2), ("ir_k5_e4_se", 1, 16, 16, -2)])
def test_block_matches_jax(name, t, cin, c, s):
    (spec,) = jfb.expand_blocks({"stages": [[(name, t, c, 1, s)]]}, [0])
    assert tfb.expand_blocks({"stages": [[(name, t, c, 1, s)]]}, [0]) == [spec]
    rs = np.random.RandomState(len(name) + c + s)
    params = _redraw(jax.tree.map(np.asarray, jfb.init_irf_block(jax.random.PRNGKey(4), cin,
                                                                  spec)), rs)
    block = tfb.Block(cin, spec)
    block.load_state_dict(params_from_jax(params), strict=True)
    x = rs.randn(2, 10, 12, cin).astype(np.float32)

    def jfn(p, a):
        y = jfb.apply_irf_block(p, a, spec, jnp.float32)
        return (y * jnp.cos(jnp.arange(y.size, dtype=jnp.float32).reshape(y.shape))).sum(), y

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = block(tx)
    got_nhwc = got.permute(0, 2, 3, 1)
    assert tuple(got_nhwc.shape) == tuple(want.shape)
    _close_scaled(got_nhwc.detach().numpy(), want)
    cot = torch.cos(torch.arange(got_nhwc.numel(), dtype=torch.float32)).reshape(got_nhwc.shape)
    (got_nhwc * cot).sum().backward()
    _grad_close(tx.grad.permute(0, 2, 3, 1), gx, "x")
    want_grads = params_from_jax(jax.tree.map(np.asarray, gp))
    for pname, p in block.named_parameters():
        _grad_close(p.grad, want_grads[pname], pname)


# -- heads ----------------------------------------------------------------------------


def test_rpn_head_matches_jax():
    jcfg, tcfg = _cfgs("e2e_mask_rcnn_fbnet.yaml")
    params = _redraw(jax.tree.map(np.asarray, jfb.init_fbnet_rpn_head(
        jax.random.PRNGKey(6), jcfg, 96, 15)), np.random.RandomState(6))
    head = tfb.FBNetRPNHead(tcfg, 96, 15)
    head.load_state_dict(params_from_jax(params), strict=True)
    assert len(head.tower) == 3
    x = np.random.RandomState(7).randn(2, 8, 10, 96).astype(np.float32)
    want = jax.jit(lambda p, a: jfb.apply_fbnet_rpn_head(p, jcfg, [a], jnp.float32))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    with torch.no_grad():
        got = head([torch.from_numpy(x).permute(0, 3, 1, 2)])
    for g, w in zip(got, want):
        _close_scaled(g[0].permute(0, 2, 3, 1).numpy(), w[0])


@pytest.mark.parametrize("which,arch,out_hw", [("bbox", "default", 3), ("mask", "default", 12),
                                               ("mask", "xirb16d_dsmask", 12)])
def test_roi_heads_match_jax(which, arch, out_hw):
    jcfg, tcfg = _cfgs(ARCH=arch, WIDTH_DIVISOR=8)
    params, cout = jfb.init_fbnet_head(jax.random.PRNGKey(8), jcfg, 96, which)
    params = _redraw(jax.tree.map(np.asarray, params), np.random.RandomState(8))
    head = tfb.FBNetROIHead(tcfg, 96, which)
    head.load_state_dict(params_from_jax(params), strict=True)
    assert head.out_dim == cout
    x = np.random.RandomState(9).randn(5, 6, 6, 96).astype(np.float32)
    want = jax.jit(lambda p, a: jfb.apply_fbnet_head(p, jcfg, a, which, jnp.float32))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    with torch.no_grad():
        got = head(torch.from_numpy(x))
    assert got.shape == (5, cout, out_hw, out_hw)
    _close_scaled(got.permute(0, 2, 3, 1).numpy(), want)


# -- the FBNet files end to end ---------------------------------------------------------


@pytest.fixture(scope="module", params=["e2e_mask_rcnn_fbnet.yaml",
                                        "e2e_faster_rcnn_fbnet_chamv1a_600.yaml"])
def setup(request):
    jcfg, tcfg = _cfgs(request.param)
    mask = tcfg.MODEL.MASK_ON
    jm = build_jax_model(jcfg)
    params = numpy_params(jm)
    # class scores spread over a few classes above SCORE_THRESH 0.05
    cls = params["roi_heads"]["box"]["predictor"]["cls_score"]
    cls["w"] = cls["w"] * 6
    tm = GeneralizedRCNN(tcfg)
    tm.load_state_dict(params_from_jax(params), strict=True)
    assert tm.box_pooler.adaptive and len(tm.box_pooler.scales) == 1
    nb = train_batch(h=HW[0], w=HW[1])
    if not mask:
        del nb["gt_masks"]
    n_props = tcfg.MODEL.RPN.POST_NMS_TOP_N_TRAIN + nb["gt_boxes"].shape[1]
    # one stride-16 map of 8 x 10 cells, 15 anchors each
    draws = jax_sampler_draws(RNG, 2, 8 * 10 * 15, n_props)
    return dict(mask=mask, jm=jm, params=jax.tree.map(jnp.asarray, params), tm=tm.eval(),
                batch=nb, draws=draws)


def test_fbnet_train_forward_losses_and_gradients_match_jax(setup):
    jm, params, tm = setup["jm"], setup["params"], setup["tm"]
    batch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    names = ["loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg"]
    names += ["loss_mask"] if setup["mask"] else []

    def loss_fn(p):
        losses = jm.train_forward(p, batch, RNG)
        return sum(jax.tree.leaves(losses)), losses

    (_, want_losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    batch_t = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    draws = {k: torch.from_numpy(v) for k, v in setup["draws"].items()}
    with torch.no_grad():
        losses = tm.train_forward(batch_t, draws=draws)
    assert list(losses) == names and set(want_losses) == set(names)
    for k in names:
        np.testing.assert_allclose(losses[k].item(), float(want_losses[k]), rtol=1e-5, err_msg=k)
    assert losses["loss_box_reg"] > 0
    # The gradients are those of the port's convolutions in float64 (the
    # losses stay float32): the RPN tower holds pre-ReLU values within
    # float32 rounding of zero (-4e-8 where float64 has -2e-8), whose ReLU
    # derivative any two float32 computations may take either way; JAX's
    # float32 gradients lie within 4e-7 of the float64 port's.
    t64 = copy.deepcopy(tm).double()
    t64.compute_dtype = torch.float64
    batch_t["images"] = t64._normalize_uint8(batch_t["images"], batch_t["image_sizes"]).double()
    sum(t64.train_forward(batch_t, draws=draws).values()).backward()
    want = params_from_jax(jax.tree.map(np.asarray, grads))
    named = dict(t64.named_parameters())
    # nothing of an FBNet body is frozen but its BN buffers
    assert all(p.requires_grad for p in named.values())
    for name, p in named.items():
        _grad_close(p.grad, want[name], name)


def test_fbnet_infer_forward_matches_jax(setup):
    jm, params, tm = setup["jm"], setup["params"], setup["tm"]
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (2,) + HW + (3,)).astype(np.uint8)
    sizes = np.array([list(HW), [112, 140]], np.int32)
    want = jax.jit(jm.infer_forward)(params, {"images": jnp.asarray(images),
                                              "image_sizes": jnp.asarray(sizes)})
    got = tm.infer_forward({"images": torch.from_numpy(images),
                            "image_sizes": torch.from_numpy(sizes)})
    keys = {"boxes", "scores", "labels", "valid"} | ({"masks"} if setup["mask"] else set())
    assert set(got) == set(want) == keys
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert want["valid"].sum() >= 6
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    if setup["mask"]:
        assert got["masks"].shape[-2:] == (12, 12)
        np.testing.assert_allclose(got["masks"], want["masks"], rtol=1e-4, atol=1e-4)


# -- the keys JAX reads nowhere ------------------------------------------------------------


def test_fbnet_keys_the_jax_package_ignores_change_nothing():
    """e2e_mask_rcnn_fbnet.yaml sets DW_CONV_SKIP_BN True and
    DET_HEAD_LAST_SCALE 0.0 (maskrcnn-benchmark: no BN and ReLU after the
    depthwise convs, the heads' last block scaled to zero). The JAX package
    reads neither, nor BN_TYPE, RPN_BN_TYPE or the head block and stride
    keys; the port follows it: flipping them all leaves both packages'
    parameter trees and the port's outputs as they were."""
    flipped = dict(DW_CONV_SKIP_BN=False, DW_CONV_SKIP_RELU=False, DET_HEAD_LAST_SCALE=1.0,
                   BN_TYPE="gn", RPN_BN_TYPE="gn", DET_HEAD_BLOCKS=[1, 2], DET_HEAD_STRIDE=2,
                   MASK_HEAD_BLOCKS=[3], MASK_HEAD_STRIDE=1, KPTS_HEAD_BLOCKS=[4],
                   KPTS_HEAD_STRIDE=2, RPN_HEAD_BLOCKS=2, MASK_HEAD_LAST_SCALE=1.0,
                   KPTS_HEAD_LAST_SCALE=1.0)
    # the port's FBNET defaults are JAX's (config/defaults.py)
    assert dict(torch_defaults.MODEL.FBNET) == dict(jax_defaults.MODEL.FBNET)
    as_written = _cfgs("e2e_mask_rcnn_fbnet.yaml")
    assert as_written[1].MODEL.FBNET.DW_CONV_SKIP_BN
    assert as_written[1].MODEL.FBNET.DET_HEAD_LAST_SCALE == 0.0
    changed = _cfgs("e2e_mask_rcnn_fbnet.yaml", **flipped)

    def jax_shapes(c):
        tree = jax.eval_shape(build_jax_model(c).init, jax.random.PRNGKey(0))
        return jax.tree.map(lambda a: a.shape, tree)

    assert jax_shapes(as_written[0]) == jax_shapes(changed[0])
    models = [GeneralizedRCNN(c[1]) for c in (as_written, changed)]
    shapes = [{k: v.shape for k, v in m.state_dict().items()} for m in models]
    assert shapes[0] == shapes[1]
    models[0].reset_parameters(torch.Generator().manual_seed(0))
    models[1].load_state_dict(models[0].state_dict())
    rs = np.random.RandomState(1)
    batch = {"images": torch.from_numpy(rs.randint(0, 256, (1,) + HW + (3,)).astype(np.uint8)),
             "image_sizes": torch.tensor([list(HW)], dtype=torch.int32)}
    a, b = (m.eval().infer_forward(batch) for m in models)
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
