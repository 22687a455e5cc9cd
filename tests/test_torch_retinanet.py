"""The port's RetinaNet against the JAX package's, on the CPU in float32.

A narrow RetinaNet R-50-FPN from configs/retinanet/retinanet_R-50-FPN_1x.yaml
(test_models.tiny, torch_port_fixtures.narrow), its JAX parameter tree drawn
in numpy from a seed (the frozen BN as torch_port_fixtures draws it, the
head's towers at He scale and its cls logits spread, so that the scores
leave the prior's 0.01 and do not tie) and handed to the port through
params_from_jax. Tolerances:
  * the octave anchors bit for bit;
  * the pyramid P3-P7 (P6 from C5 and from P5) and the head's outputs 1e-5
    of each level's max;
  * the focal loss and its gradient 1e-6 relative;
  * the match equal to JAX's dense match_proposals;
  * the cls loss 1e-5 relative to JAX's retinanet_loss; the reg loss 1e-5 to
    an oracle of JAX functions (match_proposals, encode_boxes, smooth_l1) at
    the box coder's (10, 10, 5, 5), where JAX's own loss encodes at
    (1, 1, 1, 1) (its witness below); every gradient within 2e-4 of the JAX
    gradient's max of that parameter;
  * detections: labels and validity exact, scores 1e-5, boxes 1e-3 px.
Then train_net (2 iterations) and test_net (bbox) on a synthetic COCO tree.
"""

import logging
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskrcnn_tpu.config import cfg as jax_defaults
from maskrcnn_tpu.models import build_detection_model as build_jax_model
from maskrcnn_tpu.models.anchors import make_anchor_generator_retinanet as jax_anchor_generator
from maskrcnn_tpu.models.retinanet import apply_retinanet_head, retinanet_loss as jax_loss
from maskrcnn_tpu.ops.box_ops import box_iou as jax_box_iou, encode_boxes as jax_encode
from maskrcnn_tpu.ops.losses import sigmoid_focal_loss as jax_focal, smooth_l1_loss as jax_l1
from maskrcnn_tpu.ops.matcher import match_proposals as jax_match
from maskrcnn_tpu_torch.config import cfg as torch_defaults
from maskrcnn_tpu_torch.models.anchors import make_anchor_generator_retinanet
from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN, _level_major
from maskrcnn_tpu_torch.models.retinanet import retinanet_targets
from maskrcnn_tpu_torch.ops.losses import sigmoid_focal_loss
from maskrcnn_tpu_torch.tools import test_net, train_net
from maskrcnn_tpu_torch.utils.convert import params_from_jax
from synthetic_coco import make_synthetic_coco
from test_models import tiny
from torch_port_fixtures import narrow, numpy_tree as fixture_tree, train_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RETINA = os.path.join(REPO, "configs", "retinanet")
CONFIG = os.path.join(RETINA, "retinanet_R-50-FPN_1x.yaml")
# the JAX loss's box coder (retinanet.py:94) and the one both decode with
JAX_LOSS_WEIGHTS, CODER_WEIGHTS = (1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)


def _configs(yaml=CONFIG, **retinanet):
    out = []
    for defaults in (jax_defaults, torch_defaults):
        c = defaults.clone()
        c.merge_from_file(yaml)
        narrow(tiny(c))
        c.MODEL.WEIGHT = ""
        c.MODEL.RETINANET.INFERENCE_TH = 0.02
        for k, v in retinanet.items():
            setattr(c.MODEL.RETINANET, k, v)
        out.append(c)
    return out


def numpy_tree(jm, seed=0):
    """torch_port_fixtures.numpy_tree with the head's towers at 2 / fan_in
    and its cls logits at 0.3 with the prior bias."""
    params = fixture_tree(jm, seed)
    rs = np.random.RandomState(seed + 1)
    head = params["rpn"]
    for tower in (head["cls_tower"], head["bbox_tower"]):
        for conv in tower:
            conv["w"] *= np.float32(2 ** 0.5)
    head["cls_logits"]["w"] = rs.normal(0, 0.3, head["cls_logits"]["w"].shape).astype(np.float32)
    head["cls_logits"]["b"][:] = -np.log((1 - 0.01) / 0.01)
    head["bbox_pred"]["w"] = rs.normal(0, 0.05, head["bbox_pred"]["w"].shape).astype(np.float32)
    return params


def _pair(jcfg, tcfg, seed=0):
    jm = build_jax_model(jcfg)
    params = numpy_tree(jm, seed)
    tm = GeneralizedRCNN(tcfg)
    tm.load_state_dict(params_from_jax(params), strict=True)
    return jm, jax.tree.map(jnp.asarray, params), tm.eval()


@pytest.fixture(scope="module")
def pair():
    return _pair(*_configs())


def _batch(seed=0):
    nb = train_batch(seed)
    del nb["gt_masks"]
    return nb


def _jax_head(jm, params, batch):
    """JAX's pyramid, anchors and level-concatenated head outputs."""
    images = jm._prepare_images(batch["images"], batch["image_sizes"])
    features = jm.backbone.apply(params["backbone"], images, jnp.float32)
    anchors = jnp.concatenate(jm._anchors(features), axis=0)
    cls, reg = apply_retinanet_head(params["rpn"], features, jnp.float32)
    b = images.shape[0]
    nc = jm.retina_cfg["num_classes"] - 1
    cls = jnp.concatenate([c.reshape(b, -1, nc) for c in cls], axis=1)
    reg = jnp.concatenate([r.reshape(b, -1, 4) for r in reg], axis=1)
    return features, anchors, cls, reg


def _oracle_reg(anchors, reg, gt_boxes, gt_labels, rcfg, weights):
    """The reg loss from JAX's functions: dense match_proposals with the
    low-quality restore, encode_boxes at `weights`, smooth-L1 over the
    positives / max(1, positives * BBOX_REG_WEIGHT)."""
    def per_image(gt_b, gt_l):
        m = jax_match(jax_box_iou(gt_b, anchors), gt_l > 0, rcfg["fg_iou"], rcfg["bg_iou"],
                      allow_low_quality_matches=True)
        pos = (m >= 0) & (gt_l[jnp.maximum(m, 0)] > 0)
        return pos, jax_encode(gt_b[jnp.maximum(m, 0)], anchors, weights)

    pos, targets = jax.vmap(per_image)(gt_boxes, gt_labels)
    l1 = jax_l1(reg, targets, beta=rcfg["reg_beta"])
    return jnp.sum(l1 * pos[..., None]) / jnp.maximum(1.0, jnp.sum(pos) * rcfg["reg_weight"])


@pytest.mark.parametrize("yaml", ["retinanet_R-50-FPN_1x.yaml", "retinanet_R-101-FPN_P5_1x.yaml"])
def test_octave_anchors_equal_jax_bit_for_bit(yaml):
    jcfg, tcfg = _configs(os.path.join(RETINA, yaml))
    want, got = jax_anchor_generator(jcfg), make_anchor_generator_retinanet(tcfg)
    assert got.num_anchors_per_location() == want.num_anchors_per_location() == [9] * 5
    assert got.strides == want.strides == [8, 16, 32, 64, 128]
    for level, (g, w) in enumerate(zip(got.cell_anchors, want.cell_anchors)):
        assert g.dtype == w.dtype == np.float32 and np.array_equal(g, w)
        grid = (100 // 2 ** level + 1, 168 // 2 ** level + 1)
        np.testing.assert_array_equal(got.grid_anchors_level(level, *grid, "cpu").numpy(),
                                      np.asarray(want.grid_anchors_level(level, *grid)))


@pytest.mark.parametrize("use_c5", [True, False])
def test_pyramid_and_head_equal_jax(pair, use_c5):
    """P3-P7 through the FPN over C3-C5 and P6/P7 (from C5, or from P5 as
    the *_P5 configs), then the head's outputs, in the JAX flatten order."""
    jm, params, tm = pair if use_c5 else _pair(*_configs(USE_C5=False))
    assert tm.backbone.top.p6.in_channels == (512 if use_c5 else 32)
    assert [k for k in tm.state_dict() if k.startswith("backbone.fpn.inner.")] == [
        "backbone.fpn.inner.{}.conv.{}".format(i, p) for i in (1, 2, 3) for p in ("weight", "bias")]
    nb = _batch()
    batch = {k: jnp.asarray(v) for k, v in nb.items()}
    features, _, cls, reg = jax.jit(lambda p, b: _jax_head(jm, p, b))(params, batch)
    with torch.no_grad():
        got, anchors = tm._backbone({k: torch.from_numpy(v) for k, v in nb.items()})
        gcls, greg = tm.rpn(got)
    assert [tuple(f.shape[2:]) for f in got] == [(16, 20), (8, 10), (4, 5), (2, 3), (1, 2)]
    for g, w in zip(got, features):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
    for g, w, last in ((gcls, cls, 80), (greg, reg, 4)):
        g, w = _level_major(g, 2, last).numpy(), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_focal_loss_and_its_gradient_equal_jax():
    rs = np.random.RandomState(0)
    logits = (rs.randn(300, 7) * 4).astype(np.float32)
    targets = rs.randint(-1, 8, 300).astype(np.int32)
    want = jax_focal(jnp.asarray(logits), jnp.asarray(targets), 2.0, 0.25)
    wgrad = jax.grad(lambda x: jnp.sum(jax_focal(x, jnp.asarray(targets), 2.0, 0.25) * x))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = sigmoid_focal_loss(x, torch.from_numpy(targets), 2.0, 0.25)
    (got * x).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(wgrad), rtol=1e-6, atol=1e-6)
    assert (got.detach().numpy()[targets == -1] == 0).all()


@pytest.fixture(scope="module")
def jax_losses(pair):
    """JAX's own retinanet_loss (its train_forward), the oracle at both box
    coders, and the gradient of cls + the oracle's reg at (10, 10, 5, 5)."""
    jm, params, _ = pair
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    rcfg = jm.retina_cfg

    def losses(p):
        _, anchors, cls, reg = _jax_head(jm, p, batch)
        cls_loss, reg_loss = jax_loss(anchors, cls, reg, batch["gt_boxes"], batch["gt_labels"],
                                      rcfg)
        oracle = {w: _oracle_reg(anchors, reg, batch["gt_boxes"], batch["gt_labels"], rcfg, w)
                  for w in (JAX_LOSS_WEIGHTS, CODER_WEIGHTS)}
        return cls_loss + oracle[CODER_WEIGHTS], (cls_loss, reg_loss, oracle)

    (_, (cls_loss, reg_loss, oracle)), grads = jax.jit(jax.value_and_grad(losses, has_aux=True))(
        params)
    own = jax.jit(jm.train_forward)(params, batch, jax.random.PRNGKey(0))
    return dict(cls=float(cls_loss), reg=float(reg_loss), own={k: float(v) for k, v in own.items()},
                oracle={w: float(v) for w, v in oracle.items()},
                grads=params_from_jax(jax.tree.map(np.asarray, grads)))


def test_jax_reg_loss_encodes_at_unit_weights(jax_losses):
    """The witness of the JAX package's fault (ROADMAP.md Queue 3): its
    train_forward's reg loss is the oracle at (1, 1, 1, 1), not at the
    (10, 10, 5, 5) its inference decodes with."""
    own, oracle = jax_losses["own"], jax_losses["oracle"]
    np.testing.assert_allclose(own["loss_retina_reg"], oracle[JAX_LOSS_WEIGHTS], rtol=1e-5)
    np.testing.assert_allclose(own["loss_retina_cls"], jax_losses["cls"], rtol=1e-6)
    assert abs(oracle[CODER_WEIGHTS] - oracle[JAX_LOSS_WEIGHTS]) > 0.1 * oracle[JAX_LOSS_WEIGHTS]


def test_retinanet_loss_and_gradients_equal_jax(pair, jax_losses):
    jm, params, tm = pair
    nb = _batch()
    losses = tm.train_forward({k: torch.from_numpy(v) for k, v in nb.items()})
    assert tuple(losses) == ("loss_retina_cls", "loss_retina_reg")
    np.testing.assert_allclose(losses["loss_retina_cls"].item(), jax_losses["cls"], rtol=1e-5)
    np.testing.assert_allclose(losses["loss_retina_reg"].item(),
                               jax_losses["oracle"][CODER_WEIGHTS], rtol=1e-5)
    assert losses["loss_retina_reg"] > 0
    sum(losses.values()).backward()
    want = jax_losses["grads"]
    trainable = 0
    for name, p in tm.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and name.startswith(("backbone.body.stem.",
                                                       "backbone.body.layer1."))
            continue
        trainable += 1
        scale = want[name].abs().max().item()
        err = (p.grad - want[name]).abs().max().item()
        assert err <= 2e-4 * scale, (name, err, scale)
    # layer2-4 (13 blocks of 3 convs, 3 shortcuts), 3 + 3 FPN convs and
    # P6/P7 with biases, 4 + 4 tower convs and the two predictors
    assert trainable == 42 + 12 + 4 + 20


def test_match_through_the_kernel_wrapper_equals_jax_dense_match(pair):
    """The port's labels come from match_anchors_batched (on the CPU its
    plain version); JAX's loss from the dense box_iou + match_proposals."""
    jm, params, tm = pair
    nb = _batch(seed=3)
    with torch.no_grad():
        _, anchors = tm._backbone({k: torch.from_numpy(v) for k, v in nb.items()})
    anchors = torch.cat(anchors)
    labels, matched = retinanet_targets(anchors, torch.from_numpy(nb["gt_boxes"]),
                                        torch.from_numpy(nb["gt_labels"]), 0.5, 0.4)
    for i in range(len(nb["gt_boxes"])):
        gt_l = jnp.asarray(nb["gt_labels"][i])
        want = jax_match(jax_box_iou(jnp.asarray(nb["gt_boxes"][i]), jnp.asarray(anchors.numpy())),
                         gt_l > 0, 0.5, 0.4, allow_low_quality_matches=True)
        np.testing.assert_array_equal(matched[i].numpy(), np.asarray(want))
        want_l = np.where(want >= 0, np.asarray(gt_l)[np.maximum(want, 0)],
                          np.where(want == -1, 0, -1))
        np.testing.assert_array_equal(labels[i].numpy(), want_l)
    assert (labels > 0).sum() > 0 and (labels == -1).sum() > 0


def test_retinanet_inference_equals_jax(pair):
    jm, params, tm = pair
    rs = np.random.RandomState(0)
    images = rs.randint(0, 256, (2, 128, 160, 3)).astype(np.uint8)
    sizes = np.array([[128, 160], [112, 136]], np.int32)
    want = jax.jit(jm.infer_forward)(params, {"images": jnp.asarray(images),
                                              "image_sizes": jnp.asarray(sizes)})
    got = tm.infer_forward({"images": torch.from_numpy(images),
                            "image_sizes": torch.from_numpy(sizes)})
    assert set(got) == set(want) == {"boxes", "scores", "labels", "valid"}
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert want["valid"].all() and len(np.unique(want["labels"])) > 2
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)


@pytest.mark.parametrize("yaml", sorted(y for y in os.listdir(RETINA) if "X_101" not in y))
def test_every_retinanet_config_builds_and_loads_the_jax_tree(yaml):
    """Each published RetinaNet config but the X-101 one (ROADMAP.md Queue 1
    item 10) builds, and takes the JAX tree with strict=True."""
    jcfg, tcfg = _configs(os.path.join(RETINA, yaml))
    jm = build_jax_model(jcfg)
    tm = GeneralizedRCNN(tcfg)
    tm.load_state_dict(params_from_jax(numpy_tree(jm)), strict=True)
    assert not hasattr(tm, "roi_heads") and len(tm.backbone.strides) == 5


class _LogLines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


OPTS = [
    "MODEL.DEVICE", "cpu", "MODEL.WEIGHT", "", "MODEL.RETINANET.NUM_CLASSES", "4",
    "DATASETS.TRAIN", "('coco_2017_train',)", "DATASETS.TEST", "('coco_2017_val',)",
    "MODEL.RESNETS.RES2_OUT_CHANNELS", "64", "MODEL.RESNETS.STEM_OUT_CHANNELS", "16",
    "MODEL.RESNETS.WIDTH_PER_GROUP", "16", "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", "32",
    "TPU.COMPUTE_DTYPE", "float32", "INPUT.PIXEL_STD", "[57.375, 57.12, 58.395]",
    "MODEL.RETINANET.PRE_NMS_TOP_N", "100", "TEST.DETECTIONS_PER_IMG", "10",
    "INPUT.MIN_SIZE_TRAIN", "(120,)", "INPUT.MAX_SIZE_TRAIN", "160",
    "INPUT.MIN_SIZE_TEST", "120", "INPUT.MAX_SIZE_TEST", "160",
    "SOLVER.IMS_PER_BATCH", "2", "SOLVER.BASE_LR", "0.0001", "TEST.IMS_PER_BATCH", "2",
    "TPU.MAX_GT_BOXES", "8", "DATALOADER.NUM_WORKERS", "0", "SOLVER.CHECKPOINT_PERIOD", "2",
]


def test_train_net_and_test_net_run_a_retinanet(tmp_path, monkeypatch):
    """train_net for 2 iterations, then its final test (bbox only), then
    test_net on the checkpoint, on a synthetic COCO tree of 4 images."""
    root = tmp_path / "datasets"
    img_dir, ann_file = make_synthetic_coco(str(tmp_path / "gen"), num_images=4, num_classes=3,
                                            seed=2)
    (root / "coco" / "annotations").mkdir(parents=True)
    shutil.move(img_dir, str(root / "coco" / "val2017"))
    shutil.copytree(str(root / "coco" / "val2017"), str(root / "coco" / "train2017"))
    for split in ("val2017", "train2017"):
        shutil.copy(ann_file, str(root / "coco" / "annotations" / "instances_{}.json".format(split)))
    monkeypatch.setenv("MASKRCNN_TPU_DATA_DIR", str(root))
    logs = _LogLines()
    logger = logging.getLogger("maskrcnn_tpu_torch")
    logger.addHandler(logs)
    out = tmp_path / "out"
    try:
        model, meters = train_net.main(["--config-file", CONFIG] + OPTS + [
            "SOLVER.MAX_ITER", "2", "OUTPUT_DIR", str(out)])
        (result,) = test_net.main(["--config-file", CONFIG, "--ckpt", str(out / "model_final.pth")]
                                  + OPTS + ["OUTPUT_DIR", str(tmp_path / "test")])
    finally:
        logger.removeHandler(logs)
    assert {"loss_retina_cls", "loss_retina_reg", "loss"} <= set(meters.meters)
    assert all(np.isfinite(meters.meters[k].global_avg) for k in ("loss_retina_cls",
                                                                 "loss_retina_reg"))
    marks = [x for x in logs.lines if x.startswith("Evaluating predictions")]
    assert marks == ["Evaluating predictions: bbox"] * 2, marks
    assert (out / "inference" / "coco_2017_val" / "predictions.pkl").exists()
    assert set(result[0].results) == {"bbox"}
