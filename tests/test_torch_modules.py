"""The PyTorch port's modules against the JAX package's, one by one.

Both sides run in float32 on the CPU with the same parameters (the JAX
init passed through params_from_jax) and the same numpy inputs. Tolerances:
backbone and FPN features rtol = atol = 1e-4 (the two frameworks sum the
convolutions in different orders); single layers and head math 1e-5;
labels and keep decisions exact.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskrcnn_tpu.models import layers as jl
from maskrcnn_tpu.models.anchors import make_anchor_generator as jax_anchor_generator
from maskrcnn_tpu.models.resnet import ResNetConfig, apply_resnet
from maskrcnn_tpu.models.roi_heads import box_head as jbh
from maskrcnn_tpu.models.roi_heads import mask_head as jmh
from maskrcnn_tpu.models.rpn import apply_rpn_head, make_rpn_cfg
from maskrcnn_tpu.models.rpn import select_proposals as jax_select_proposals
from maskrcnn_tpu.ops import box_ops as jbox
from maskrcnn_tpu_torch.models import build_detection_model as build_torch_model
from maskrcnn_tpu_torch.models import layers as tl
from maskrcnn_tpu_torch.models.anchors import make_anchor_generator
from maskrcnn_tpu_torch.models.roi_heads.box_head import box_head_inference
from maskrcnn_tpu_torch.models.rpn import select_proposals
from maskrcnn_tpu_torch.ops import box_ops as tbox
from maskrcnn_tpu_torch.utils.convert import params_from_jax
from torch_port_fixtures import configs, model_pair, random_boxes


@pytest.fixture(scope="module")
def pair():
    return model_pair()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


# -- layers ---------------------------------------------------------------------


def test_frozen_bn_has_no_eps_and_folds_into_conv():
    rs = np.random.RandomState(0)
    c = 8
    bn = {"scale": rs.uniform(0.5, 2, c), "bias": rs.randn(c), "mean": rs.randn(c),
          "var": rs.uniform(1e-4, 1e-3, c)}  # tiny var: an eps would show
    bn = {k: v.astype(np.float32) for k, v in bn.items()}
    conv = {"w": rs.randn(3, 3, 4, c).astype(np.float32)}
    x = rs.randn(2, 9, 11, 4).astype(np.float32)

    tbn = tl.FrozenBatchNorm2d(c)
    sd = params_from_jax({"bn": bn})
    tbn.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    tconv = tl.Conv2d(4, c, 3, padding=1, bias=False)
    tconv.weight.data.copy_(params_from_jax({"c": conv})["c.weight"])

    y = rs.randn(2, c, 5, 6).astype(np.float32)
    want_bn = jl.frozen_bn(jnp.asarray(y.transpose(0, 2, 3, 1)), {k: jnp.asarray(v) for k, v in bn.items()})
    _close(_nhwc(tbn(torch.from_numpy(y))), want_bn, 1e-5)

    from maskrcnn_tpu.models.resnet import conv_norm
    want = conv_norm(jnp.asarray(x), {"w": jnp.asarray(conv["w"])},
                     {k: jnp.asarray(v) for k, v in bn.items()}, "bn", 32,
                     padding=1, compute_dtype=jnp.float32)
    got = tl.conv_frozen_bn(_nchw(x), tconv, tbn)
    _close(_nhwc(got), want, 1e-4)


def test_conv_transpose_flip_matches_jax():
    rs = np.random.RandomState(1)
    p = {"w": rs.randn(2, 2, 6, 5).astype(np.float32), "b": rs.randn(5).astype(np.float32)}
    x = rs.randn(3, 4, 7, 6).astype(np.float32)
    want = jl.conv_transpose2d(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                               stride=2, compute_dtype=jnp.float32)
    m = tl.ConvTranspose2d(6, 5, 2, stride=2)
    sd = params_from_jax({"conv5_mask": p})
    m.load_state_dict({"weight": sd["conv5_mask.weight"], "bias": sd["conv5_mask.bias"]})
    _close(_nhwc(m(_nchw(x))), want, 1e-5)


def test_linear_pool_and_upsample_match_jax():
    rs = np.random.RandomState(2)
    p = {"w": rs.randn(12, 7).astype(np.float32), "b": rs.randn(7).astype(np.float32)}
    x = rs.randn(5, 12).astype(np.float32)
    lin = tl.Linear(12, 7)
    sd = params_from_jax({"fc": p})
    lin.load_state_dict({"weight": sd["fc.weight"], "bias": sd["fc.bias"]})
    want = jl.linear(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, jnp.float32)
    _close(lin(torch.from_numpy(x)).detach(), want, 1e-5)

    f = rs.randn(2, 9, 13, 3).astype(np.float32)
    _close(_nhwc(tl.max_pool2d(_nchw(f))), jl.max_pool2d(jnp.asarray(f)), 0)
    _close(_nhwc(tl.nearest_upsample2x(_nchw(f))), jl.nearest_upsample2x(jnp.asarray(f)), 0)


# -- backbone -------------------------------------------------------------------


def _image(seed=3, h=128, w=160):
    return np.random.RandomState(seed).randn(2, h, w, 3).astype(np.float32)


def test_resnet_body_matches_jax(pair):
    jm, params, tm = pair
    jcfg, _ = configs()
    x = _image()
    rcfg = ResNetConfig(jcfg)
    want = jax.jit(lambda p, x: apply_resnet(p, x, rcfg, jnp.float32))(
        params["backbone"]["body"], jnp.asarray(x))
    with torch.no_grad():
        got = tm.backbone.body(_nchw(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(_nhwc(g), w, 1e-4)


def test_fpn_pyramid_matches_jax(pair):
    jm, params, tm = pair
    x = _image()
    want = jax.jit(lambda p, x: jm.backbone.apply(p, x, jnp.float32))(
        params["backbone"], jnp.asarray(x))
    with torch.no_grad():
        got = tm.backbone(_nchw(x).contiguous(memory_format=torch.channels_last))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.shape[2:] == w.shape[1:3]
        _close(_nhwc(g), w, 1e-4)


# -- box ops and anchors -----------------------------------------------------------


def test_box_ops_match_jax():
    rs = np.random.RandomState(4)
    boxes = random_boxes(rs, 50, 0, 200, 1, 120)
    codes = (rs.randn(50, 12) * 2).astype(np.float32)  # large dw/dh hit the clip
    weights = (10.0, 10.0, 5.0, 5.0)
    _close(tbox.decode_boxes(torch.from_numpy(codes), torch.from_numpy(boxes), weights),
           jbox.decode_boxes(jnp.asarray(codes), jnp.asarray(boxes), weights), 1e-5)
    h = np.array([[150.0], [90.0]], np.float32)
    w = np.array([[170.0], [60.0]], np.float32)
    b2 = np.stack([boxes[:25], boxes[25:]])
    got = tbox.clip_boxes_to_image(torch.from_numpy(b2), (torch.from_numpy(h), torch.from_numpy(w)))
    want = jbox.clip_boxes_to_image(jnp.asarray(b2), (jnp.asarray(h), jnp.asarray(w)))
    _close(got, want, 0)
    np.testing.assert_array_equal(tbox.small_box_mask(got, 20).numpy(),
                                  np.asarray(jbox.small_box_mask(want, 20)))
    _close(tbox.box_iou(torch.from_numpy(boxes), torch.from_numpy(boxes[:7])),
           jbox.box_iou(jnp.asarray(boxes), jnp.asarray(boxes[:7])), 1e-6)


def test_anchors_match_jax():
    jcfg, tcfg = configs()
    ja = jax_anchor_generator(jcfg)
    ta = make_anchor_generator(tcfg)
    assert ta.num_anchors_per_location() == ja.num_anchors_per_location()
    for level, (gh, gw) in enumerate([(32, 40), (16, 20), (8, 10), (4, 5), (2, 3)]):
        _close(ta.grid_anchors_level(level, gh, gw, "cpu"), ja.grid_anchors_level(level, gh, gw), 0)


# -- RPN ------------------------------------------------------------------------------


def _pyramid(seed, c, b=2, shapes=((32, 40), (16, 20), (8, 10), (4, 5), (2, 3))):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, h, w, c).astype(np.float32) for h, w in shapes]


def test_rpn_head_matches_jax(pair):
    jm, params, tm = pair
    feats = _pyramid(5, 32)
    jo, jr = jax.jit(lambda p, f: apply_rpn_head(p, f, jnp.float32))(
        params["rpn"], [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        to, tr = tm.rpn([_nchw(f) for f in feats])
    for a, b in zip(to + tr, jo + jr):
        _close(_nhwc(a), b, 1e-5)


@pytest.mark.parametrize("pre_nms,post_nms", [(64, 32), (500, 200)])
def test_select_proposals_matches_jax(pre_nms, post_nms):
    jcfg, tcfg = configs()
    for c in (jcfg, tcfg):
        c.MODEL.RPN.PRE_NMS_TOP_N_TEST = pre_nms
        c.MODEL.RPN.POST_NMS_TOP_N_TEST = post_nms
        c.MODEL.RPN.FPN_POST_NMS_TOP_N_TEST = post_nms
    shapes = ((32, 40), (16, 20), (8, 10), (4, 5), (2, 3))
    rs = np.random.RandomState(6)
    obj = [(rs.randn(2, h, w, 3) * 2).astype(np.float32) for h, w in shapes]
    reg = [(rs.randn(2, h, w, 12) * 0.3).astype(np.float32) for h, w in shapes]
    sizes = np.array([[128, 160], [100, 150]], np.int32)
    ja = jax_anchor_generator(jcfg)
    anchors = [np.asarray(ja.grid_anchors_level(l, h, w)) for l, (h, w) in enumerate(shapes)]
    rpn_cfg = make_rpn_cfg(jcfg)
    jb, js, jv = jax.jit(lambda a, o, r, s: jax_select_proposals(a, o, r, s, rpn_cfg, False))(
        [jnp.asarray(a) for a in anchors], [jnp.asarray(o) for o in obj],
        [jnp.asarray(r) for r in reg], jnp.asarray(sizes))
    tb, ts, tv = select_proposals(
        [torch.tensor(a) for a in anchors], [_nchw(o) for o in obj],
        [_nchw(r) for r in reg], torch.from_numpy(sizes), tcfg.MODEL.RPN)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the final top-k leaves the order of tied scores open: compare sorted sets
    for i in range(2):
        v = np.asarray(jv[i])
        want = np.concatenate([np.asarray(js[i])[v, None], np.asarray(jb[i])[v]], 1)
        got = np.concatenate([ts[i].numpy()[v, None], tb[i].numpy()[v]], 1)
        want = want[np.lexsort(want.T[::-1])]
        got = got[np.lexsort(got.T[::-1])]
        _close(got, want, 1e-5)


# -- box head -------------------------------------------------------------------------


def test_box_head_extractor_and_predictor_match_jax(pair):
    jm, params, tm = pair
    jcfg, _ = configs()
    pooled = np.random.RandomState(7).randn(20, 7, 7, 32).astype(np.float32)
    bp = params["roi_heads"]["box"]

    def head(p, x):
        x = jbh.apply_box_feature_extractor(p["feature_extractor"], x, jcfg, jnp.float32)
        return jbh.apply_box_predictor(p["predictor"], x, jcfg, jnp.float32)

    jlog, jreg = jax.jit(head)(bp, jnp.asarray(pooled))
    with torch.no_grad():
        tlog, treg = tm.roi_heads.box(torch.from_numpy(pooled))
    _close(tlog, jlog, 1e-5)
    _close(treg, jreg, 1e-5)


@pytest.mark.parametrize("score_thresh,nms,agnostic", [
    (0.05, 0.5, False), (0.2, 0.3, False), (0.05, 0.5, True)])
def test_box_head_inference_matches_jax(score_thresh, nms, agnostic):
    rs = np.random.RandomState(8)
    b, n, c = 2, 160, 9
    logits = (rs.randn(b, n, c) * 2).astype(np.float32)
    reg = (rs.randn(b, n, 8 if agnostic else 4 * c) * 0.5).astype(np.float32)
    props = np.stack([random_boxes(rs, n, 0, 150, 5, 80) for _ in range(b)])
    pvalid = rs.uniform(size=(b, n)) > 0.1
    sizes = np.array([[140, 150], [120, 100]], np.int32)
    weights = (10.0, 10.0, 5.0, 5.0)
    want = jax.jit(lambda *a: jbh.box_head_inference(
        *a, weights, score_thresh, nms, 12, cls_agnostic=agnostic))(
        jnp.asarray(logits), jnp.asarray(reg), jnp.asarray(props), jnp.asarray(pvalid),
        jnp.asarray(sizes))
    got = box_head_inference(torch.from_numpy(logits), torch.from_numpy(reg),
                             torch.from_numpy(props), torch.from_numpy(pvalid),
                             torch.from_numpy(sizes), weights, score_thresh, nms, 12,
                             cls_agnostic=agnostic)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    _close(got["scores"], want["scores"], 1e-5)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), atol=1e-3, rtol=0)


# -- mask head ------------------------------------------------------------------------


def test_mask_head_matches_jax(pair):
    jm, params, tm = pair
    jcfg, _ = configs()
    rs = np.random.RandomState(9)
    pooled = rs.randn(6, 14, 14, 32).astype(np.float32)
    labels = rs.randint(1, 81, 6).astype(np.int32)
    mp = params["roi_heads"]["mask"]

    def head(p, x):
        x = jmh.apply_mask_feature_extractor(p["feature_extractor"], x, jcfg, jnp.float32)
        return jmh.apply_mask_predictor(p["predictor"], x, jcfg, jnp.float32)

    logits = np.asarray(jax.jit(head)(mp, jnp.asarray(pooled)))
    want = 1 / (1 + np.exp(-logits[np.arange(6), :, :, labels]))
    with torch.no_grad():
        got = tm.roi_heads.mask(torch.from_numpy(pooled), torch.from_numpy(labels))
    assert got.shape == (6, 28, 28)
    _close(got, want, 1e-5)


def test_device_normalization_matches_jax(pair):
    jm, params, tm = pair
    rs = np.random.RandomState(10)
    img = rs.randint(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    sizes = np.array([[64, 96], [50, 70]], np.int32)
    want = jm._prepare_images(jnp.asarray(img), jnp.asarray(sizes))
    got = tm._prepare_images(torch.from_numpy(img), torch.from_numpy(sizes))
    _close(got, want, 1e-6)


def test_registered_meta_architecture_is_built_from_the_config():
    """models/registry.py: build_detection_model consults META_ARCHITECTURES
    before GeneralizedRCNN, as the JAX package's does; a name registered
    twice raises."""
    from maskrcnn_tpu_torch.models import registry

    class Tiny(torch.nn.Module):
        def __init__(self, cfg):
            super().__init__()
            self.cfg = cfg
            self.w = torch.nn.Parameter(torch.zeros(3))

        def reset_parameters(self, generator):
            with torch.no_grad():
                self.w.uniform_(generator=generator)

    name = "TinyTestDetector"
    registry.META_ARCHITECTURES.register(name, Tiny)
    try:
        _, c = configs()
        c.MODEL.META_ARCHITECTURE = name
        a, b = build_torch_model(c, device="cpu", seed=4), build_torch_model(c, device="cpu", seed=4)
        assert isinstance(a, Tiny) and a.cfg is c and not a.training
        assert torch.equal(a.w, b.w) and a.w.abs().sum() > 0
        with pytest.raises(KeyError):
            registry.META_ARCHITECTURES.register(name, Tiny)

        @registry.META_ARCHITECTURES.register(name + "2")
        def build(cfg):
            return Tiny(cfg)

        assert registry.META_ARCHITECTURES[name + "2"] is build
        c.MODEL.META_ARCHITECTURE = "NoSuchDetector"
        with pytest.raises(ValueError):
            build_torch_model(c, device="cpu")
    finally:
        registry.META_ARCHITECTURES.pop(name)
        registry.META_ARCHITECTURES.pop(name + "2", None)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_to_image_list_matches_jax(kind):
    from maskrcnn_tpu.structures.image_list import to_image_list as jax_to_image_list
    from maskrcnn_tpu_torch.structures.image_list import ImageList, to_image_list

    rs = np.random.RandomState(0)
    images = [rs.rand(h, w, 3).astype(np.float32) for h, w in ((37, 50), (64, 33), (20, 20))]
    given = images if kind == "numpy" else [torch.from_numpy(im) for im in images]
    for kw in ({}, {"size_divisible": 32}, {"target_shape": (96, 96)}):
        want = jax_to_image_list(images, **kw)
        got = to_image_list(given, **kw)
        assert isinstance(got, ImageList) and got.image_sizes == want.image_sizes
        np.testing.assert_array_equal(np.asarray(got.tensors), want.tensors)
    with pytest.raises(ValueError):
        to_image_list(given, target_shape=(32, 32))
    batch = to_image_list(given[0])
    assert len(batch) == 1 and to_image_list(batch) is batch


def test_env_hook_import_file_and_collect_env(tmp_path):
    """utils/env.py runs MASKRCNN_TPU_ENV_MODULE's setup_environment when it
    is imported (a file path, through utils/imports.import_file, or a
    module name); utils/collect_env.py names torch, CUDA, cuDNN and nvcc."""
    import subprocess
    import sys

    from maskrcnn_tpu_torch.utils.collect_env import collect_env_info
    from maskrcnn_tpu_torch.utils.imports import import_file

    hook = tmp_path / "my_env.py"
    hook.write_text("import os\n"
                    "def setup_environment():\n"
                    "    print('hook ran', os.environ['MASKRCNN_TPU_ENV_MODULE'])\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for target, path in ((str(hook), repo), ("my_env", str(tmp_path) + os.pathsep + repo)):
        env = dict(os.environ, MASKRCNN_TPU_ENV_MODULE=target, PYTHONPATH=path)
        out = subprocess.run([sys.executable, "-c", "import maskrcnn_tpu_torch.utils.env"],
                             env=env, capture_output=True, text=True, timeout=120, cwd=repo)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "hook ran " + target
    mod = import_file("my_env_module", str(hook), make_importable=True)
    assert callable(mod.setup_environment) and sys.modules["my_env_module"] is mod
    sys.modules.pop("my_env_module")
    info = collect_env_info()
    for key in ("PyTorch: " + torch.__version__, "PyTorch CUDA:", "cuDNN:", "Devices:", "nvcc:"):
        assert key in info
