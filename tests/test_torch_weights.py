"""Pretrained weights in the port: Detectron .pkl and maskrcnn-benchmark .pth
files, catalog:// names and the local cache, against the JAX package.

* ``load_c2_weights`` on Detectron files written here (chip_smoke.py's
  ``detectron_blobs``: an ImageNet R-50 and R-101 backbone with an fc1000 and
  momentum blobs; a whole Mask R-CNN with fc6 at C=256, P=7, which takes the
  (C, P, P) -> (P, P, C) permutation, and the mask deconv) equals JAX
  ``load_c2_weights`` followed by ``params_from_jax``, bit for bit, with the
  same count of tensors loaded; the model starts from the JAX template's
  own init on both sides, so the tensors kept at init agree too.
* Serving from the whole detector's file gives JAX's detections at the
  tolerances of tests/test_torch_detector.py (labels and validity exact,
  scores 1e-5, boxes 1e-3 px, masks 1e-4).
* ``load_pth_weights`` on a "module."-prefixed maskrcnn-benchmark state dict
  equals the JAX loader's.
* RetinaNet: a maskrcnn-benchmark RetinaNet .pth (its towers'
  interleaved Sequential indices, ``fpn.top_blocks.p6/p7``, the FPN's
  ``fpn_inner2..4``) equals the JAX loader's bit for bit, every port name
  has JAX's reference key, and the synthetic R-50.pkl fills a RetinaNet's
  body through ``catalog://`` with the Mask R-CNN body's tensors.
* ``ModelCatalog`` gives JAX's URL for every name; ``cache_url`` reads a
  pre-populated cache and never reaches the network (urllib raises here),
  raises naming where to place a missing file, and gives two Detectron
  baselines two files; ``DetectronCheckpointer`` loads ``catalog://`` names
  and ``.pkl`` files, and a resume checkpoint still wins over them.
"""

import logging
import os
import re
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskrcnn_tpu.config import cfg as jax_defaults
from maskrcnn_tpu_torch.config import cfg as torch_defaults
from test_models import tiny
from torch_port_fixtures import narrow
from chip_smoke import detectron_blobs, write_pkl
from maskrcnn_tpu.config.paths_catalog import ModelCatalog as JaxModelCatalog
from maskrcnn_tpu.models import build_detection_model as build_jax_model
from maskrcnn_tpu.utils import c2_loading as jax_c2
from maskrcnn_tpu.utils.checkpoint import _flatten_params
from maskrcnn_tpu.utils.model_zoo import cache_url as jax_cache_url
from maskrcnn_tpu_torch.config.paths_catalog import ModelCatalog
from maskrcnn_tpu_torch.models import build_detection_model
from maskrcnn_tpu_torch.utils import c2_loading
from maskrcnn_tpu_torch.utils.checkpoint import Checkpointer, DetectronCheckpointer
from maskrcnn_tpu_torch.utils.convert import params_from_jax
from maskrcnn_tpu_torch.utils.model_zoo import cache_url, cached_name
from torch_port_fixtures import configs, numpy_params

R50 = "catalog://ImageNetPretrained/MSRA/R-50"
BASELINE = "catalog://Caffe2Detectron/COCO/35858933/e2e_mask_rcnn_R-50-FPN_1x"


def _no_network(*args, **kwargs):
    raise urllib.error.URLError("no network in the tests")


@pytest.fixture
def offline(monkeypatch, tmp_path):
    """An empty weight cache and a urllib that raises."""
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv("MASKRCNN_TPU_CACHE", str(cache))
    monkeypatch.setattr(urllib.request, "urlretrieve", _no_network)
    return cache


def _seeded_tree(shapes, rs, bn):
    """A parameter tree of the JAX model's shapes (jax.eval_shape, no
    compile): frozen BN dicts from bn(rs, c), other leaves N(0, 0.05)."""
    if isinstance(shapes, dict):
        if set(shapes) == {"scale", "bias", "mean", "var"}:
            return bn(rs, shapes["scale"].shape[0])
        return {k: _seeded_tree(v, rs, bn) for k, v in shapes.items()}
    if isinstance(shapes, (list, tuple)):
        return [_seeded_tree(v, rs, bn) for v in shapes]
    if shapes is None:  # an empty FPN slot
        return None
    return rs.normal(0, 0.05, shapes.shape).astype(np.float32)


def _identity_bn(rs, c):
    return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32),
            "mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}


def _random_bn(rs, c):
    return {"scale": rs.uniform(0.3, 0.7, c).astype(np.float32),
            "bias": rs.uniform(-0.1, 0.1, c).astype(np.float32),
            "mean": rs.uniform(-0.1, 0.1, c).astype(np.float32),
            "var": rs.uniform(0.5, 1.5, c).astype(np.float32)}


def _pair(body="R-50-FPN", fpn_channels=None):
    """Both configs, the JAX model and a seeded template of its parameters
    (frozen BN at its init: scale and var 1, bias and mean 0)."""
    jcfg, tcfg = configs()
    for c in (jcfg, tcfg):
        c.MODEL.BACKBONE.CONV_BODY = body
        if fpn_channels:
            c.MODEL.RESNETS.BACKBONE_OUT_CHANNELS = fpn_channels
    jm = build_jax_model(jcfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    return jcfg, tcfg, jm, _seeded_tree(shapes, np.random.RandomState(100), _identity_bn)


def _port_model(tcfg, template):
    model = build_detection_model(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(template), strict=True)
    return model


def _random_state(jm, seed):
    """A seeded state of the port's names, as numpy: random frozen BN."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tree = _seeded_tree(shapes, np.random.RandomState(seed), _random_bn)
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


def _jax_count(caplog):
    counts = [re.match(r"loaded (\d+)/(\d+) tensors", r.getMessage())
              for r in caplog.records if r.name == jax_c2.__name__]
    counts = [m for m in counts if m]
    assert len(counts) == 1
    return int(counts[0][1]), int(counts[0][2])


def _assert_equal_to_jax(model, loaded, jax_params, caplog):
    model.load_state_dict(loaded, strict=False)
    want = params_from_jax(jax_params)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert _jax_count(caplog) == (len(loaded), len(got))


@pytest.mark.parametrize("body,layer3", [("R-50-FPN", 6), ("R-101-FPN", 23)])
def test_imagenet_pkl_equals_jax(tmp_path, caplog, body, layer3):
    jcfg, tcfg, jm, template = _pair(body)
    state = _random_state(jm, seed=1)
    blobs = detectron_blobs(np, state, imagenet=True)
    assert "res4_{}_branch2c_w".format(layer3 - 1) in blobs and "fc1000_w_momentum" in blobs
    path = str(tmp_path / "{}.pkl".format(body))
    write_pkl(path, blobs, wrap=False)
    with caplog.at_level(logging.INFO):
        want = jax_c2.load_c2_weights(path, jcfg, template)
    model = _port_model(tcfg, template)
    loaded = c2_loading.load_c2_weights(path, tcfg, model.state_dict())
    _assert_equal_to_jax(model, loaded, want, caplog)
    # the body's convs and BN affine pairs load, its running statistics and
    # the FPN and heads keep their init
    body_keys = [k for k in loaded if k.startswith("backbone.body.")]
    assert len(body_keys) == len(loaded)
    assert all(not k.endswith(("running_mean", "running_var")) for k in loaded)
    conv = "backbone.body.layer3.{}.conv3.weight".format(layer3 - 1)
    assert torch.equal(loaded[conv], torch.from_numpy(state[conv]))


def test_x101_imagenet_pkl_equals_jax(tmp_path, caplog):
    """An ImageNet X-101-32x8d file (grouped res convs, here 4 groups of 4
    channels, the stride in the 3x3) loads as JAX's loader loads it."""
    jcfg, tcfg = configs()
    for c in (jcfg, tcfg):
        c.merge_from_file(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "configs", "e2e_faster_rcnn_X_101_32x8d_FPN_1x.yaml"))
        narrow(tiny(c))
        c.MODEL.RESNETS.NUM_GROUPS, c.MODEL.RESNETS.WIDTH_PER_GROUP = 4, 4
        c.MODEL.WEIGHT = ""
    jm = build_jax_model(jcfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    template = _seeded_tree(shapes, np.random.RandomState(100), _identity_bn)
    state = _random_state(jm, seed=4)
    conv2 = "backbone.body.layer3.22.conv2.weight"
    assert state[conv2].shape == (64, 16, 3, 3)  # 4 groups: 16 of the 64 inputs each
    path = str(tmp_path / "X-101-32x8d.pkl")
    write_pkl(path, detectron_blobs(np, state, imagenet=True), wrap=False)
    with caplog.at_level(logging.INFO):
        want = jax_c2.load_c2_weights(path, jcfg, template)
    model = _port_model(tcfg, template)
    loaded = c2_loading.load_c2_weights(path, tcfg, model.state_dict())
    _assert_equal_to_jax(model, loaded, want, caplog)
    assert torch.equal(loaded[conv2], torch.from_numpy(state[conv2]))


def _detections_equal(got, want):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["masks"], want["masks"], rtol=1e-4, atol=1e-4)


def test_detectron_model_final_equals_jax_and_serves(tmp_path, caplog):
    jcfg, tcfg, jm, template = _pair(fpn_channels=256)
    # the JAX test parameters (bounded activations, spread class scores)
    state = {k: v.numpy() for k, v in params_from_jax(numpy_params(jm, seed=2)).items()}
    fc6 = state["roi_heads.box.feature_extractor.fc6.weight"]
    assert fc6.shape[1] == 7 * 7 * 256
    blobs = detectron_blobs(np, state)
    # the reference's flatten order, not the port's
    assert not np.array_equal(blobs["fc6_w"], fc6)
    path = str(tmp_path / "model_final.pkl")
    write_pkl(path, blobs, wrap=True)
    with caplog.at_level(logging.INFO):
        want = jax_c2.load_c2_weights(path, jcfg, template)
    model = _port_model(tcfg, template)
    loaded = c2_loading.load_c2_weights(path, tcfg, model.state_dict())
    _assert_equal_to_jax(model, loaded, want, caplog)
    # every entry loads but the frozen BN's running statistics, which a
    # Detectron file does not hold: fc6 permuted back, the deconv as is
    kept = set(model.state_dict()) - set(loaded)
    assert kept and all(k.endswith(("running_mean", "running_var")) for k in kept)
    for k in ("roi_heads.box.feature_extractor.fc6.weight",
              "roi_heads.mask.predictor.conv5_mask.weight"):
        assert torch.equal(loaded[k], torch.from_numpy(state[k])), k

    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (2, 128, 160, 3)).astype(np.uint8)
    sizes = np.array([[128, 160], [112, 136]], np.int32)
    jdet = jax.jit(jm.infer_forward)(jax.tree.map(jnp.asarray, want),
                                     {"images": jnp.asarray(images),
                                      "image_sizes": jnp.asarray(sizes)})
    tdet = model.infer_forward({"images": torch.from_numpy(images),
                                "image_sizes": torch.from_numpy(sizes)})
    jdet = {k: np.asarray(v) for k, v in jdet.items()}
    assert jdet["valid"].sum() >= 8
    _detections_equal({k: v.numpy() for k, v in tdet.items()}, jdet)


_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _port_name(path, flat):
    """The port's name of a JAX tree path (utils/convert.py's naming)."""
    parts = path.split("/")
    parent = "/".join(parts[:-1])
    if parent + "/scale" in flat and parent + "/var" in flat:
        return ".".join(parts[:-1] + [_BN[parts[-1]]])
    return ".".join(parts[:-1] + [{"w": "weight", "b": "bias"}.get(parts[-1], parts[-1])])


def test_pth_weights_equal_jax(tmp_path, caplog):
    jcfg, tcfg, jm, template = _pair()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    params = _seeded_tree(shapes, np.random.RandomState(3), _random_bn)
    reference = params_from_jax(params)  # torch layouts
    # a maskrcnn-benchmark checkpoint: the reference's keys (JAX
    # torchstyle_key_for_path), "module."-prefixed, torch layouts
    flat = {k: v for k, v in _flatten_params(params).items() if v is not None}
    state = {}
    for path in flat:
        key = jax_c2._resolve_convk(jax_c2.torchstyle_key_for_path(path), "/" + path + "/")
        state["module." + key] = reference[_port_name(path, flat)].clone()
    assert len(state) == len(flat) == len(reference)
    path = str(tmp_path / "model_final.pth")
    torch.save({"model": state, "iteration": 90000}, path)
    with caplog.at_level(logging.INFO):
        want = jax_c2.load_pth_weights(path, jcfg, template)
    model = _port_model(tcfg, template)
    loaded = c2_loading.load_pth_weights(path, tcfg, model.state_dict())
    _assert_equal_to_jax(model, loaded, want, caplog)
    assert len(loaded) == len(reference)
    for name, value in reference.items():
        assert torch.equal(loaded[name], value), name


@pytest.mark.parametrize("body", ["R-50-FPN", "R-101-FPN"])
def test_reference_keys_equal_jax(body):
    """The port's rename table gives every state_dict entry the reference's
    key that the JAX package's path rewriter gives the same tensor."""
    _, _, jm, _ = _pair(body)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    flat = {k: v for k, v in _flatten_params(shapes).items() if v is not None}
    assert flat
    for path in flat:
        want = jax_c2._resolve_convk(jax_c2.torchstyle_key_for_path(path), "/" + path + "/")
        assert c2_loading.torchstyle_key(_port_name(path, flat)) == want, path


def test_model_catalog_urls_equal_jax():
    names = (["ImageNetPretrained/" + k for k in JaxModelCatalog._IMAGENET]
             + ["Caffe2Detectron/COCO/" + k for k in JaxModelCatalog._DETECTRON_12_2017])
    assert len(names) == 16
    for name in names:
        assert ModelCatalog.get(name) == JaxModelCatalog.get(name), name
    with pytest.raises(RuntimeError):
        ModelCatalog.get("Elsewhere/R-50")


def test_cache_url_reads_the_cache_offline(offline):
    url = ModelCatalog.get(R50[len("catalog://"):])
    with pytest.raises(RuntimeError, match="place it at .*R-50.pkl"):
        cache_url(url)
    assert not list(offline.iterdir())  # no partial file left behind
    (offline / "R-50.pkl").write_bytes(b"weights")
    # the JAX package's cache file for an ImageNet name: one cache serves both
    assert cache_url(url) == jax_cache_url(url) == str(offline / "R-50.pkl")
    # every Detectron baseline ends in .../model_final.pkl: each its own file
    urls = [ModelCatalog.get("Caffe2Detectron/COCO/" + k)
            for k in ModelCatalog._DETECTRON_12_2017]
    files = {cached_name(u) for u in urls}
    assert len(files) == len(urls) and all(f.endswith("_model_final.pkl") for f in files)
    for u in urls[:2]:
        (offline / cached_name(u)).write_bytes(u.encode())
    assert [open(cache_url(u), "rb").read() for u in urls[:2]] == [u.encode() for u in urls[:2]]


def test_detectron_checkpointer_catalog_and_pkl(offline, tmp_path):
    jcfg, tcfg, jm, template = _pair()
    state = _random_state(jm, seed=4)
    write_pkl(str(offline / "R-50.pkl"), detectron_blobs(np, state, imagenet=True), wrap=False)
    conv = "backbone.body.layer2.0.conv2.weight"

    model = _port_model(tcfg, template)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    assert DetectronCheckpointer(tcfg, model, save_dir="").load(R50) == {}
    got = model.state_dict()
    assert torch.equal(got[conv], torch.from_numpy(state[conv]))
    assert torch.equal(got["rpn.conv.weight"], init["rpn.conv.weight"])

    path = str(tmp_path / "detector.pkl")
    write_pkl(path, detectron_blobs(np, state), wrap=True)
    model = _port_model(tcfg, template)
    DetectronCheckpointer(tcfg, model, save_dir="").load(path)
    assert torch.equal(model.state_dict()["rpn.conv.weight"],
                       torch.from_numpy(state["rpn.conv.weight"]))

    # a resume checkpoint in save_dir wins over the catalog name
    out = tmp_path / "out"
    Checkpointer(_port_model(tcfg, template), save_dir=str(out)).save("model_0000002",
                                                                      iteration=2)
    model = _port_model(tcfg, template)
    extra = DetectronCheckpointer(tcfg, model, save_dir=str(out)).load(R50)
    assert extra == {"iteration": 2}
    assert torch.equal(model.state_dict()[conv], init[conv])
    # a baseline that is not in the cache: no network, the path to place it at
    with pytest.raises(RuntimeError, match="place it at"):
        DetectronCheckpointer(tcfg, model, save_dir="").load(BASELINE)
    assert os.listdir(offline) == ["R-50.pkl"]


def _retina_pair(body="R-50-FPN-RETINANET"):
    """_pair for the RetinaNet config at the test widths."""
    out = []
    for defaults in (jax_defaults, torch_defaults):
        c = defaults.clone()
        c.merge_from_file(os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                                       "retinanet", "retinanet_R-50-FPN_1x.yaml"))
        narrow(tiny(c))
        c.MODEL.WEIGHT = ""
        c.MODEL.BACKBONE.CONV_BODY = body
        out.append(c)
    jcfg, tcfg = out
    jm = build_jax_model(jcfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    return jcfg, tcfg, jm, _seeded_tree(shapes, np.random.RandomState(100), _identity_bn)


@pytest.mark.parametrize("body", ["R-50-FPN-RETINANET", "R-101-FPN-RETINANET"])
def test_retinanet_reference_keys_equal_jax(body):
    _, _, jm, _ = _retina_pair(body)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    flat = {k: v for k, v in _flatten_params(shapes).items() if v is not None}
    keys = set()
    for path in flat:
        want = jax_c2._resolve_convk(jax_c2.torchstyle_key_for_path(path), "/" + path + "/")
        assert c2_loading.torchstyle_key(_port_name(path, flat)) == want, path
        keys.add(want)
    # the reference's module names
    assert {"rpn.head.cls_tower.0.weight", "rpn.head.cls_tower.6.weight",
            "rpn.head.bbox_tower.6.bias", "rpn.head.cls_logits.weight", "rpn.head.bbox_pred.bias",
            "backbone.fpn.top_blocks.p6.weight", "backbone.fpn.top_blocks.p7.bias",
            "backbone.fpn.fpn_inner2.weight", "backbone.fpn.fpn_layer4.bias"} <= keys
    assert not any("fpn_inner1" in k or "fpn_layer1" in k for k in keys)


def test_retinanet_pth_equals_jax(tmp_path, caplog):
    jcfg, tcfg, jm, template = _retina_pair()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    params = _seeded_tree(shapes, np.random.RandomState(5), _random_bn)
    reference = params_from_jax(params)
    flat = {k: v for k, v in _flatten_params(params).items() if v is not None}
    state = {}
    for path in flat:
        key = jax_c2._resolve_convk(jax_c2.torchstyle_key_for_path(path), "/" + path + "/")
        state[key] = reference[_port_name(path, flat)].clone()
    assert len(state) == len(flat) == len(reference)
    path = str(tmp_path / "retinanet.pth")
    torch.save({"model": state}, path)
    with caplog.at_level(logging.INFO):
        want = jax_c2.load_pth_weights(path, jcfg, template)
    model = _port_model(tcfg, template)
    loaded = c2_loading.load_pth_weights(path, tcfg, model.state_dict())
    model.load_state_dict(loaded, strict=True)
    want = params_from_jax(want)
    assert set(want) == set(loaded) == set(reference)
    for name, value in reference.items():
        assert torch.equal(loaded[name], value) and torch.equal(want[name], value), name
    # JAX's count of the tree's leaves takes in the FPN's two empty slots
    assert _jax_count(caplog) == (len(loaded), len(loaded) + 2)


def test_imagenet_pkl_fills_a_retinanet_body(offline, caplog):
    """The synthetic R-50.pkl through catalog:// in DetectronCheckpointer:
    a RetinaNet's body takes the tensors a Mask R-CNN's takes, and equals
    JAX's loader; its FPN, P6/P7 and head keep their init."""
    _, mcfg, mjm, mtemplate = _pair()
    jcfg, tcfg, jm, template = _retina_pair()
    state = _random_state(mjm, seed=6)
    write_pkl(str(offline / "R-50.pkl"), detectron_blobs(np, state, imagenet=True), wrap=False)
    mask_rcnn = _port_model(mcfg, mtemplate)
    DetectronCheckpointer(mcfg, mask_rcnn, save_dir="").load(R50)
    model = _port_model(tcfg, template)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    DetectronCheckpointer(tcfg, model, save_dir="").load(R50)
    got, body = model.state_dict(), mask_rcnn.state_dict()
    assert all(torch.equal(got[k], body[k]) for k in got if k.startswith("backbone.body."))
    moved = {k for k in got if not torch.equal(got[k], init[k])}
    assert moved and all(k.startswith("backbone.body.") for k in moved)
    with caplog.at_level(logging.INFO):
        want = jax_c2.load_c2_weights(str(offline / "R-50.pkl"), jcfg, template)
    want = params_from_jax(want)
    assert all(torch.equal(got[k], v) for k, v in want.items())


# -- group norm and C4 (GN baselines, R-50-C4) ----------------------------------------


def _gn_pair():
    """A narrow GN Mask R-CNN (GN stem, bottlenecks and FPN, Xconv1fc box
    head with GN; the mask head without the group norms the JAX package's
    lacks) in both packages, and a seeded JAX template."""
    jcfg, tcfg = jax_defaults.clone(), torch_defaults.clone()
    for c in (jcfg, tcfg):
        c.merge_from_file(os.path.join(REPO, "configs", "gn_baselines",
                                       "e2e_mask_rcnn_R_50_FPN_Xconv1fc_1x_gn.yaml"))
        narrow(tiny(c))
        c.MODEL.WEIGHT = ""
        c.MODEL.GROUP_NORM.NUM_GROUPS = 2
        c.MODEL.ROI_BOX_HEAD.CONV_HEAD_DIM = 32
        c.MODEL.ROI_MASK_HEAD.USE_GN = False
    jm = build_jax_model(jcfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    return jcfg, tcfg, jm, _seeded_tree(shapes, np.random.RandomState(100), _identity_bn)


def _c4_pair(name="e2e_mask_rcnn_R_50_C4_1x.yaml"):
    jcfg, tcfg = jax_defaults.clone(), torch_defaults.clone()
    for c in (jcfg, tcfg):
        c.merge_from_file(os.path.join(REPO, "configs", name))
        narrow(tiny(c))
        c.MODEL.WEIGHT = ""
        c.MODEL.RESNETS.BACKBONE_OUT_CHANNELS = c.MODEL.RESNETS.RES2_OUT_CHANNELS * 4
    jm = build_jax_model(jcfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    return jcfg, tcfg, jm, _seeded_tree(shapes, np.random.RandomState(100), _identity_bn)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_gn_imagenet_pkl_equals_jax(tmp_path, caplog):
    """A synthetic R-50-GN.pkl (Detectron's conv1_gn_s / res*_branch*_gn_s
    names) through catalog://ImageNetPretrained/MSRA/R-50-GN loads as JAX's
    loader loads it, bit for bit and by count: the body's convs and group
    norms, nothing of the FPN or the heads."""
    jcfg, tcfg, jm, template = _gn_pair()
    state = _random_state(jm, seed=5)
    blobs = detectron_blobs(np, state, imagenet=True)
    assert "conv1_gn_s" in blobs and "res2_0_branch1_gn_b" in blobs
    assert not any(k.endswith(("_bn_s", "_bn_b")) for k in blobs)
    path = str(tmp_path / "R-50-GN.pkl")
    write_pkl(path, blobs, wrap=False)
    with caplog.at_level(logging.INFO):
        want = jax_c2.load_c2_weights(path, jcfg, template)
    model = _port_model(tcfg, template)
    loaded = c2_loading.load_c2_weights(path, tcfg, model.state_dict())
    _assert_equal_to_jax(model, loaded, want, caplog)
    body = [k for k in model.state_dict() if k.startswith("backbone.body.")]
    assert sorted(loaded) == sorted(body)
    assert sum(k.endswith(".scale") for k in loaded) == 1 + 3 * 16 + 4
    for k in ("backbone.body.stem.bn1.scale", "backbone.body.layer4.0.downsample.bn.bias"):
        assert torch.equal(loaded[k], torch.from_numpy(state[k])), k


def test_gn_imagenet_pkl_through_the_catalog(offline, caplog):
    jcfg, tcfg, jm, template = _gn_pair()
    state = _random_state(jm, seed=6)
    name = "catalog://ImageNetPretrained/MSRA/R-50-GN"
    url = ModelCatalog.get(name[len("catalog://"):])
    assert url == JaxModelCatalog.get(name[len("catalog://"):])
    write_pkl(str(offline / cached_name(url)), detectron_blobs(np, state, imagenet=True),
              wrap=False)
    model = _port_model(tcfg, template)
    tcfg.MODEL.WEIGHT = name
    with caplog.at_level(logging.INFO):
        DetectronCheckpointer(tcfg, model).load(name)
    got = model.state_dict()
    for k, v in state.items():
        if k.startswith("backbone.body."):
            assert torch.equal(got[k], torch.from_numpy(v)), k


def test_c4_detectron_model_final_equals_jax_and_serves(tmp_path, caplog):
    """A synthetic Detectron Mask R-CNN R-50-C4 model_final.pkl: res2-res4
    in the body, res5 in the box head (head.layer4), the single-level RPN's
    conv_rpn / rpn_cls_logits / rpn_bbox_pred, the predictors and the mask
    deconv, loaded bit for bit and by count as JAX loads it; then served
    against JAX at tests/test_torch_detector.py's tolerances."""
    jcfg, tcfg, jm, template = _c4_pair()
    state = {k: v.numpy() for k, v in params_from_jax(numpy_params(jm, seed=2)).items()}
    assert not any(k.startswith("roi_heads.mask.feature_extractor") for k in state)
    blobs = detectron_blobs(np, state)
    assert {"res5_2_branch2c_w", "res4_5_branch2c_bn_s", "conv_rpn_w", "rpn_cls_logits_w",
            "conv5_mask_w"} <= set(blobs)
    assert not any("fpn" in k or k.startswith("fc6") for k in blobs)
    path = str(tmp_path / "model_final.pkl")
    write_pkl(path, blobs, wrap=True)
    with caplog.at_level(logging.INFO):
        want = jax_c2.load_c2_weights(path, jcfg, template)
    model = _port_model(tcfg, template)
    loaded = c2_loading.load_c2_weights(path, tcfg, model.state_dict())
    _assert_equal_to_jax(model, loaded, want, caplog)
    kept = set(model.state_dict()) - set(loaded)
    assert kept and all(k.endswith(("running_mean", "running_var")) for k in kept)
    k = "roi_heads.box.feature_extractor.head.layer4.2.conv3.weight"
    assert torch.equal(loaded[k], torch.from_numpy(state[k]))

    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (2, 256, 320, 3)).astype(np.uint8)
    sizes = np.array([[256, 320], [224, 300]], np.int32)
    jdet = jax.jit(jm.infer_forward)(jax.tree.map(jnp.asarray, want),
                                     {"images": jnp.asarray(images),
                                      "image_sizes": jnp.asarray(sizes)})
    tdet = model.infer_forward({"images": torch.from_numpy(images),
                                "image_sizes": torch.from_numpy(sizes)})
    jdet = {k: np.asarray(v) for k, v in jdet.items()}
    assert jdet["valid"].sum() >= 8
    _detections_equal({k: v.numpy() for k, v in tdet.items()}, jdet)


@pytest.mark.parametrize("pair", ["gn", "c4"])
def test_gn_and_c4_reference_keys_equal_jax(pair):
    """Every GN and C4 tensor takes the reference key of the JAX package's
    path rewriter: a group norm's scale as weight, the Xconv head's convs k
    as xconvs.{3k}, an FPN conv's group norm under its conv's name, the C4
    res5 as roi_heads.box.feature_extractor.head.layer4."""
    _, _, jm, _ = _gn_pair() if pair == "gn" else _c4_pair()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    flat = {k: v for k, v in _flatten_params(shapes).items() if v is not None}
    for path in flat:
        want = jax_c2._resolve_convk(jax_c2.torchstyle_key_for_path(path), "/" + path + "/")
        assert c2_loading.torchstyle_key(_port_name(path, flat)) == want, path


def test_jax_gn_heads_take_no_group_norm_and_the_port_follows():
    """A witness of the JAX package's departure from maskrcnn-benchmark
    (ROADMAP.md Queue 3): under ROI_BOX_HEAD.USE_GN and ROI_MASK_HEAD.USE_GN
    the JAX FPN2MLPFeatureExtractor and MaskRCNNFPNFeatureExtractor hold no
    group norm (the reference's make_fc / make_conv3x3 with use_gn put one
    after each fc and conv, and drop the convs' biases). The port's mask
    head follows maskrcnn-benchmark: each conv without its bias and with a
    group norm; its FPN2MLP head still follows JAX, with no fc group norm;
    everything else is JAX's tree, name for name and shape for shape."""
    jcfg, tcfg = configs()
    for c in (jcfg, tcfg):
        c.merge_from_file(os.path.join(REPO, "configs", "gn_baselines",
                                       "scratch_e2e_mask_rcnn_R_50_FPN_3x_gn.yaml"))
        narrow(tiny(c))
        c.MODEL.GROUP_NORM.NUM_GROUPS = 2
    assert tcfg.MODEL.ROI_BOX_HEAD.USE_GN and tcfg.MODEL.ROI_MASK_HEAD.USE_GN
    jm = build_jax_model(jcfg)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    heads = shapes["roi_heads"]
    assert set(heads["box"]["feature_extractor"]) == {"fc6", "fc7"}
    assert all(set(c) == {"conv"} and set(c["conv"]) == {"w", "b"}
               for c in heads["mask"]["feature_extractor"]["convs"])
    want = {k: tuple(v.shape) for k, v in params_from_jax(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    model = build_detection_model(tcfg, device="cpu")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    mask = "roi_heads.mask.feature_extractor.convs."
    widths = tcfg.MODEL.ROI_MASK_HEAD.CONV_LAYERS
    assert {k for k in got if k.startswith(mask)} == {
        mask + "{}.{}".format(i, leaf) for i in range(len(widths))
        for leaf in ("conv.weight", "gn.scale", "gn.bias")}
    for i, width in enumerate(widths):
        assert got[mask + "{}.gn.scale".format(i)] == got[mask + "{}.gn.bias".format(i)] == (width,)
        assert got[mask + "{}.conv.weight".format(i)] == want[mask + "{}.conv.weight".format(i)]
    assert {k for k in want if k.startswith(mask)} - set(got) == {
        mask + "{}.conv.bias".format(i) for i in range(len(widths))}
    assert {k: v for k, v in got.items() if not k.startswith(mask)} == {
        k: v for k, v in want.items() if not k.startswith(mask)}
    assert not any(".gn." in k for k in got if k.startswith("roi_heads.box."))

def test_gn_mask_head_pth_loads_onto_its_group_norms(tmp_path):
    """A maskrcnn-benchmark .pth of a GN Mask R-CNN: each mask conv k the
    Sequential mask_fcn{k+1} = (conv without bias, group norm), so
    mask_fcn{k+1}.0.weight loads onto convs.k.conv.weight and .1.weight /
    .1.bias onto convs.k.gn.scale / .gn.bias, each equal to its source, and
    nothing else of the model takes them."""
    tcfg = torch_defaults.clone()
    tcfg.merge_from_file(os.path.join(REPO, "configs", "gn_baselines",
                                      "e2e_mask_rcnn_R_50_FPN_Xconv1fc_1x_gn.yaml"))
    narrow(tiny(tcfg))
    tcfg.MODEL.WEIGHT = ""
    tcfg.MODEL.GROUP_NORM.NUM_GROUPS = 2
    tcfg.MODEL.ROI_BOX_HEAD.CONV_HEAD_DIM = 32
    model = build_detection_model(tcfg, device="cpu")
    template = model.state_dict()
    rs = np.random.RandomState(7)
    source = {k: torch.from_numpy(rs.randn(*v.shape).astype(np.float32))
              for k, v in template.items()}
    mask = "roi_heads.mask.feature_extractor."
    names = {mask + "convs.{}.{}".format(i, a): mask + "mask_fcn{}.{}".format(i + 1, b)
             for i in range(len(tcfg.MODEL.ROI_MASK_HEAD.CONV_LAYERS))
             for a, b in (("conv.weight", "0.weight"), ("gn.scale", "1.weight"),
                          ("gn.bias", "1.bias"))}
    assert set(names) == {k for k in template if k.startswith(mask)}
    state = {"module." + names[k]: v for k, v in source.items() if k in names}
    path = str(tmp_path / "model_final.pth")
    torch.save({"model": state}, path)
    loaded = c2_loading.load_pth_weights(path, tcfg, template)
    assert set(loaded) == set(names)
    for k in names:
        assert torch.equal(loaded[k], source[k]), k
