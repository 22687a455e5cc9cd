"""The port's deformable convolutions against the JAX package's, on the CPU
in float32:

* ``deform_conv2d`` v1 and v2 (ops/deform_conv.py) at strides 1-2,
  dilations 1-2, 1-2 deformable groups and 1-2 groups, with offsets of a few
  cells (samples across cell borders and past the map's edge): the output,
  and the gradients of the input, the offsets, the mask and the weight;
* ``deform_psroi_pool`` with and without offsets, and its gradients;
* the DCN bottleneck (v1 and v2, stride 2, a shortcut) and a DCN R-50-FPN
  body from its config, with the offset convs drawn non-zero;
* the four configs/dcn/ files at the narrow widths of torch_port_fixtures:
  train_forward's losses and every gradient on JAX's sampler draws, and
  the detections;
* a synthetic Detectron R-50.pkl loaded into a DCN body by both packages:
  the same tensors, the offset convs kept at their zero init;
* the port's own short training of the two Faster DCN files (the JAX
  package's test_models.py::test_dcn_gn_short_train_smoke, which goes
  non-finite in JAX; ROADMAP.md Queue 3): at its settings the port blows
  up too, with or without deformable convs; from calibrated frozen BN it
  trains.

Tolerances: forward 1e-5; every gradient within 2e-4 of the JAX gradient's
max, but the Mask files' mask branch within 3e-3 (JAX's own jitted and
eager gradients differ there by 2.05e-3; see the test); losses rtol 1e-5;
detections: labels and validity exact, scores 1e-5, boxes 1e-3 px, masks
1e-4; weights bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import R50_RESIDUAL_SCALE, calibrate_frozen_bn, detectron_blobs, write_pkl
from maskrcnn_tpu.config import cfg as jax_defaults
from maskrcnn_tpu.models import build_detection_model as build_jax_model
from maskrcnn_tpu.models.backbone import build_backbone as build_jax_backbone
from maskrcnn_tpu.models.resnet import apply_bottleneck, init_bottleneck
from maskrcnn_tpu.ops import deform_conv as jdc
from maskrcnn_tpu.utils import c2_loading as jax_c2
from maskrcnn_tpu_torch.config import cfg as torch_defaults
from maskrcnn_tpu_torch.engine import make_train_step
from maskrcnn_tpu_torch.models.backbone import build_backbone
from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN
from maskrcnn_tpu_torch.models.resnet import Bottleneck
from maskrcnn_tpu_torch.ops import deform_conv as tdc
from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer
from maskrcnn_tpu_torch.utils import c2_loading
from maskrcnn_tpu_torch.utils.convert import params_from_jax
from test_models import make_batch, tiny
from torch_port_fixtures import one_torch_thread  # noqa: F401
from torch_port_fixtures import _redraw, jax_sampler_draws, narrow, numpy_params, train_batch

pytestmark = pytest.mark.usefixtures("one_torch_thread")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = jax.random.PRNGKey(3)
DCN_FILES = ["dcn/e2e_faster_rcnn_dconv_R_50_FPN_1x.yaml",
             "dcn/e2e_faster_rcnn_mdconv_R_50_FPN_1x.yaml",
             "dcn/e2e_mask_rcnn_dconv_R_50_FPN_1x.yaml",
             "dcn/e2e_mask_rcnn_mdconv_R_50_FPN_1x.yaml"]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def _grad_close(got, want, name="", tol=2e-4):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, (name, err, scale)


# -- the ops ---------------------------------------------------------------------


@pytest.mark.parametrize("modulated,stride,dilation,dgroups,groups", [
    (False, 1, 1, 1, 1), (True, 1, 1, 1, 1), (True, 2, 1, 2, 1), (False, 1, 2, 2, 2),
    (True, 2, 2, 1, 2)])
def test_deform_conv2d_matches_jax(modulated, stride, dilation, dgroups, groups):
    rs = np.random.RandomState(stride + 2 * dilation + 4 * dgroups + 8 * groups)
    b, h, w, cin, cout, k = 2, 9, 11, 8, 6, 3
    pad = dilation
    oh = (h + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    ow = (w + 2 * pad - dilation * (k - 1) - 1) // stride + 1
    x = rs.randn(b, h, w, cin).astype(np.float32)
    # offsets of up to a few cells: corners across borders and past the edges
    off = (rs.randn(b, oh, ow, 2 * dgroups * k * k) * 1.7).astype(np.float32)
    mask = rs.uniform(0.1, 1, (b, oh, ow, dgroups * k * k)).astype(np.float32) \
        if modulated else None
    w_hwio = (rs.randn(k, k, cin // groups, cout) / np.sqrt(k * k * cin)).astype(np.float32)
    cot = rs.randn(b, oh, ow, cout).astype(np.float32)
    kw = dict(stride=stride, padding=pad, dilation=dilation, groups=groups,
              deformable_groups=dgroups)

    def jfn(x_, o_, m_, w_):
        y = jdc.deform_conv2d(x_, o_, w_, mask=m_, compute_dtype=jnp.float32, **kw)
        return (y * cot).sum(), y

    args = [jnp.asarray(v) for v in (x, off, mask if modulated else np.zeros(1), w_hwio)]
    if not modulated:
        args[2] = None
    argnums = (0, 1, 2, 3) if modulated else (0, 1, 3)
    (_, want), jgrads = jax.jit(jax.value_and_grad(jfn, argnums=argnums, has_aux=True))(*args)

    tx = torch.from_numpy(x).requires_grad_()
    to = torch.from_numpy(off).requires_grad_()
    tm = torch.from_numpy(mask).requires_grad_() if modulated else None
    tw = torch.from_numpy(w_hwio.transpose(3, 2, 0, 1).copy()).requires_grad_()
    got = tdc.deform_conv2d(tx, to, tw, tm, compute_dtype=torch.float32, **kw)
    assert got.shape == (b, oh, ow, cout) and got.dtype == torch.float32
    _close(got.detach(), want, 1e-5)
    (got * torch.from_numpy(cot)).sum().backward()
    names = ["x", "offsets", "mask", "weight"] if modulated else ["x", "offsets", "weight"]
    ours = {"x": tx.grad, "offsets": to.grad, "weight": tw.grad.permute(2, 3, 1, 0),
            "mask": tm.grad if modulated else None}
    for name, jg in zip(names, jgrads):
        _grad_close(ours[name].numpy(), jg, name)
    # some samples fall outside the map: their offsets take no gradient
    assert (to.grad == 0).any() and (to.grad != 0).float().mean() > 0.5


@pytest.mark.parametrize("with_offsets", [False, True])
def test_deform_psroi_pool_matches_jax(with_offsets):
    rs = np.random.RandomState(11)
    b, h, w, c, p, r = 2, 12, 14, 5, 3, 7
    feat = rs.randn(b, h, w, c).astype(np.float32)
    ctr = rs.uniform(10, 90, (r, 2))
    wh = rs.uniform(8, 70, (r, 2))
    rois = np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)
    bidx = rs.randint(0, b, r).astype(np.int32)
    off = rs.randn(r, p, p, 2).astype(np.float32) * 3 if with_offsets else None
    cot = rs.randn(r, p, p, c).astype(np.float32)

    def jfn(f, o):
        y = jdc.deform_psroi_pool(f, jnp.asarray(rois), jnp.asarray(bidx), o, 0.125, p,
                                  sample_per_part=4, trans_std=0.1)
        return (y * cot).sum(), y

    argnums = (0, 1) if with_offsets else (0,)
    (_, want), jgrads = jax.jit(jax.value_and_grad(jfn, argnums=argnums, has_aux=True))(
        jnp.asarray(feat), None if off is None else jnp.asarray(off))
    tf = torch.from_numpy(feat).requires_grad_()
    to = torch.from_numpy(off).requires_grad_() if with_offsets else None
    got = tdc.deform_psroi_pool(tf, torch.from_numpy(rois), torch.from_numpy(bidx), to, 0.125,
                                p, sample_per_part=4, trans_std=0.1)
    _close(got.detach(), want, 1e-5)
    (got * torch.from_numpy(cot)).sum().backward()
    _grad_close(tf.grad, jgrads[0], "features")
    if with_offsets:
        _grad_close(to.grad, jgrads[1], "offsets")


# -- the bottleneck and the body ----------------------------------------------------


def _offset_weights(tree, rs):
    """Draw every conv2_offset of a JAX tree non-zero: offsets of about a
    cell (w ~ N(0, 1 / fan_in)), masks around the sigmoid's middle."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "conv2_offset":
                fan_in = int(np.prod(v["w"].shape[:-1]))
                out[k] = {"w": rs.normal(0, fan_in ** -0.5, v["w"].shape).astype(np.float32),
                          "b": rs.normal(0, 0.3, v["b"].shape).astype(np.float32)}
            else:
                out[k] = _offset_weights(v, rs)
        return out
    if isinstance(tree, list):
        return [_offset_weights(v, rs) for v in tree]
    return tree


@pytest.mark.parametrize("modulated", [False, True])
def test_dcn_bottleneck_matches_jax(modulated):
    dcn = dict(modulated=modulated, deformable_groups=1)
    rs = np.random.RandomState(5)
    params = _redraw(jax.tree.map(np.asarray, init_bottleneck(
        jax.random.PRNGKey(1), 16, 8, 32, 1, "bn", dcn=dcn)), rs)
    params = _offset_weights(params, rs)
    assert params["conv2_offset"]["w"].shape == (3, 3, 8, 27 if modulated else 18)
    block = Bottleneck(16, 8, 32, stride=2, dilation=1, num_groups=1, stride_in_1x1=True,
                       dcn=dcn)
    block.load_state_dict(params_from_jax(params), strict=True)
    x = rs.randn(2, 13, 15, 16).astype(np.float32)
    cot = rs.randn(2, 7, 8, 32).astype(np.float32)

    def jfn(p, a):
        y = apply_bottleneck(p, a, 2, 1, 1, True, "bn", 32, jnp.float32, dcn=dcn)
        return (y * cot).sum(), y

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    got = block(tx)
    _close(got.detach().permute(0, 2, 3, 1), want, 1e-5)
    (got * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    _grad_close(tx.grad.permute(0, 2, 3, 1), gx, "x")
    want_grads = params_from_jax(jax.tree.map(np.asarray, gp))
    for name, p in block.named_parameters():
        _grad_close(p.grad, want_grads[name], name)


def _dcn_configs(name):
    jcfg, tcfg = jax_defaults.clone(), torch_defaults.clone()
    for c in (jcfg, tcfg):
        c.merge_from_file(os.path.join(REPO, "configs", name))
        narrow(tiny(c))
        c.MODEL.WEIGHT = ""
    return jcfg, tcfg


def test_dcn_body_matches_jax():
    """The mdconv R-50-FPN body at narrow widths: layer2-4 deformable
    (STAGE_WITH_DCN (False, True, True, True)), every output level."""
    jcfg, tcfg = _dcn_configs("dcn/e2e_mask_rcnn_mdconv_R_50_FPN_1x.yaml")
    jb = build_jax_backbone(jcfg)
    rs = np.random.RandomState(9)
    params = _offset_weights(_redraw(jax.tree.map(np.asarray, jb.init(jax.random.PRNGKey(0))),
                                     rs), rs)
    tb = build_backbone(tcfg)
    tb.load_state_dict(params_from_jax(params), strict=True)
    blocks = [m for m in tb.modules() if isinstance(m, Bottleneck)]
    assert [m.dcn is not None for m in blocks] == [False] * 3 + [True] * 13
    x = rs.randn(2, 96, 128, 3).astype(np.float32)
    want = jax.jit(lambda p, a: jb.apply(p, a, jnp.float32))(jax.tree.map(jnp.asarray, params),
                                                              jnp.asarray(x))
    with torch.no_grad():
        got = tb(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 5
    for g, w_ in zip(got, want):
        w_ = np.asarray(w_)
        _close(g.permute(0, 2, 3, 1).numpy() / np.abs(w_).max(), w_ / np.abs(w_).max(), 1e-5)


# -- the four DCN files ----------------------------------------------------------------


@pytest.fixture(scope="module", params=DCN_FILES)
def setup(request):
    jcfg, tcfg = _dcn_configs(request.param)
    assert tuple(tcfg.MODEL.RESNETS.STAGE_WITH_DCN) == (False, True, True, True)
    jm = build_jax_model(jcfg)
    rs = np.random.RandomState(2)
    params = _offset_weights(numpy_params(jm), rs)
    tm = GeneralizedRCNN(tcfg)
    tm.load_state_dict(params_from_jax(params), strict=True)
    nb = train_batch(h=128, w=160)
    if not tcfg.MODEL.MASK_ON:
        del nb["gt_masks"]
    # P2-P6 of a 128 x 160 batch, 3 anchors a cell
    n_anchors = 3 * sum(-(-128 // s) * -(-160 // s) for s in (4, 8, 16, 32, 64))
    n_props = tcfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN + nb["gt_boxes"].shape[1]
    draws = jax_sampler_draws(RNG, 2, n_anchors, n_props)
    return dict(mask=tcfg.MODEL.MASK_ON, modulated=tcfg.MODEL.RESNETS.WITH_MODULATED_DCN,
                jm=jm, params=jax.tree.map(jnp.asarray, params), tm=tm.eval(), batch=nb,
                draws=draws)


def test_dcn_train_forward_losses_and_gradients_match_jax(setup):
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
    sum(losses.values()).backward()
    want = params_from_jax(jax.tree.map(np.asarray, grads))
    offsets = 0
    for name, p in tm.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and name.startswith(("backbone.body.stem.",
                                                       "backbone.body.layer1.")), name
            continue
        # the mask branch at 3e-3: JAX's jitted gradients there differ from
        # its own eager ones by 2.05e-3 of their max on this batch (a ReLU of
        # the mask head taken either way), and the port, within 2.2e-6 of
        # the eager ones, meets the jitted ones or not with its threads'
        # summation order (ROADMAP.md Queue 3)
        tol = 3e-3 if name.startswith("roi_heads.mask.") else 2e-4
        _grad_close(p.grad, want[name], name, tol)
        offsets += "conv2_offset" in name
    assert offsets == 2 * 13  # weight and bias of layer2-4's 13 blocks


def test_dcn_infer_forward_matches_jax(setup):
    jm, params, tm = setup["jm"], setup["params"], setup["tm"]
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (2, 128, 160, 3)).astype(np.uint8)
    sizes = np.array([[128, 160], [112, 136]], np.int32)
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
        np.testing.assert_allclose(got["masks"], want["masks"], rtol=1e-4, atol=1e-4)


# -- weights ------------------------------------------------------------------------


def test_r50_pkl_loads_into_a_dcn_body_as_in_jax(tmp_path):
    """Detectron's R-50 has no offset convs: both packages load the body's
    blobs and keep the 13 offset convs at their zero init."""
    jcfg, tcfg = _dcn_configs("dcn/e2e_faster_rcnn_mdconv_R_50_FPN_1x.yaml")
    tm = GeneralizedRCNN(tcfg)
    tm.reset_parameters(torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    blobs = detectron_blobs(np, {k: v.numpy() for k, v in state.items()
                                 if "conv2_offset" not in k}, imagenet=True)
    path = str(tmp_path / "R-50.pkl")
    write_pkl(path, blobs, wrap=False)
    loaded = c2_loading.load_c2_weights(path, tcfg, tm.state_dict())
    jm = build_jax_model(jcfg)
    template = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    want = params_from_jax(jax_c2.load_c2_weights(path, jcfg, template))
    body = [k for k in loaded if k.startswith("backbone.body.")]
    assert body and all(torch.equal(loaded[k], want[k]) for k in body)
    offsets = [k for k in want if "conv2_offset" in k]
    assert len(offsets) == 26 and not any(k in loaded for k in offsets)
    assert all(not want[k].any() for k in offsets)  # JAX keeps its zero init
    tm.load_state_dict(loaded, strict=False)
    assert all(not tm.state_dict()[k].any() for k in offsets)
    assert torch.equal(tm.state_dict()["backbone.body.layer3.2.conv2.weight"],
                       state["backbone.body.layer3.2.conv2.weight"])


# -- the port's short training (the JAX package's smoke test) ---------------------------


def _short_train(name, dcn=True, calibrated=False):
    """Six steps on one batch of the tiny config of `name` at BASE_LR 0.02
    with no warm-up (test_models.py::test_dcn_gn_short_train_smoke's
    settings), at torch_port_fixtures.narrow's widths in float32 (R-50's
    depth, where the growth through identity frozen BN comes from), from
    seeded random weights; with calibrated=True the frozen
    BNs are first set from the batch with each block's residual BNs at
    R50_RESIDUAL_SCALE, as chip_smoke.py's synthetic R-50.pkl holds them.
    Returns the metrics of each step and the offset convs before and after."""
    c = tiny(torch_defaults.clone())
    c.merge_from_file(os.path.join(REPO, "configs", name))
    c = narrow(tiny(c))
    c.MODEL.DEVICE, c.MODEL.WEIGHT = "cpu", ""
    c.SOLVER.BASE_LR, c.SOLVER.WARMUP_ITERS = 0.02, 0
    if not dcn:
        c.MODEL.RESNETS.STAGE_WITH_DCN = (False,) * 4
    model = GeneralizedRCNN(c)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.train()
    batch = {k: torch.from_numpy(np.array(v)) for k, v in make_batch(with_targets=True).items()
             if k != "gt_keypoints"}
    if calibrated:
        calibrate_frozen_bn(torch, model, batch["images"], residual_scale=R50_RESIDUAL_SCALE)
    optimizer = make_optimizer(c, model)
    step = make_train_step(model, optimizer, make_lr_scheduler(c, optimizer),
                           generator=torch.Generator().manual_seed(2))
    before = {k: v.detach().clone() for k, v in model.named_parameters() if "offset" in k}
    metrics = [{k: v.item() for k, v in step(batch).items()} for _ in range(6)]
    after = {k: v.detach() for k, v in model.named_parameters() if "offset" in k}
    return metrics, before, after


def test_reference_smoke_settings_diverge_with_and_without_dcn():
    """The JAX package's DCN smoke test goes non-finite at step 3. The port
    at the same settings blows up too, and so does the same body without
    deformable convs: it is the rate on random weights with identity frozen
    BN (R-50's activations grow by orders of magnitude), not the deformable
    op, whose gradients the tests above hold to JAX's."""
    for dcn in (True, False):
        losses = [m["loss"] for m in _short_train(DCN_FILES[0], dcn=dcn)[0]]
        assert not np.isfinite(losses[-1]) or losses[-1] > 1e3 * losses[0], (dcn, losses)


@pytest.mark.parametrize("name", DCN_FILES[:2])
def test_dcn_short_train(name):
    """test_models.py::test_dcn_gn_short_train_smoke for the port, at its
    rate and with no warm-up, from the body as chip_smoke.py's synthetic
    R-50.pkl calibrates it: every metric of the six steps finite, the loss
    lower at the end, the offset convs moved."""
    metrics, before, after = _short_train(name, calibrated=True)
    for i, m in enumerate(metrics):
        for k, v in m.items():
            assert np.isfinite(v), "step {}: non-finite {}".format(i, k)
    losses = [m["loss"] for m in metrics]
    assert losses[-1] < losses[0], losses
    assert len(before) == 26 and any(not torch.equal(v, after[k]) for k, v in before.items())
