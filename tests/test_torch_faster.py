"""The port's Faster R-CNN (MASK_ON False) against the JAX package's, on the
CPU in float32: R-50-FPN and R-101-FPN from their published configs
(configs/e2e_faster_rcnn_R_{50,101}_FPN_1x.yaml) at the narrow widths of
torch_port_fixtures, the JAX parameter tree drawn in numpy
(torch_port_fixtures.numpy_tree, the box predictor spread as numpy_params
spreads it) and handed over through params_from_jax.

* ``train_forward`` with the samplers' draws JAX makes from its key
  (jax_sampler_draws): the four losses rtol 1e-5, every trainable
  parameter's gradient within 2e-4 of the JAX gradient's max, the frozen
  stages (stem, layer1) without one;
* ``infer_forward``: labels and validity exact, scores 1e-5, boxes 1e-3 px.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskrcnn_tpu.config import cfg as jax_defaults
from maskrcnn_tpu.models import build_detection_model as build_jax_model
from maskrcnn_tpu_torch.config import cfg as torch_defaults
from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN
from maskrcnn_tpu_torch.utils.convert import params_from_jax
from test_models import tiny
from torch_port_fixtures import jax_sampler_draws, narrow, numpy_tree, train_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg")
RNG = jax.random.PRNGKey(3)
# the stages' blocks of each depth: layer2-4 trainable
BLOCKS = {"R-50": (4, 6, 3), "R-101": (4, 23, 3)}


@pytest.fixture(scope="module", params=["R-50", "R-101"])
def setup(request):
    yaml = os.path.join(REPO, "configs", "e2e_faster_rcnn_{}_FPN_1x.yaml".format(
        request.param.replace("-", "_")))
    jcfg, tcfg = jax_defaults.clone(), torch_defaults.clone()
    for c in (jcfg, tcfg):
        c.merge_from_file(yaml)
        narrow(tiny(c))
        c.MODEL.WEIGHT = ""
    assert not tcfg.MODEL.MASK_ON and tcfg.MODEL.BACKBONE.CONV_BODY == request.param + "-FPN"
    jm = build_jax_model(jcfg)
    tree = numpy_tree(jm)
    pred = tree["roi_heads"]["box"]["predictor"]
    rs = np.random.RandomState(1)
    pred["cls_score"]["w"] = rs.normal(0, 0.3, pred["cls_score"]["w"].shape).astype(np.float32)
    pred["bbox_pred"]["w"] = rs.normal(0, 0.02, pred["bbox_pred"]["w"].shape).astype(np.float32)
    params = jax.tree.map(jnp.asarray, tree)
    tm = GeneralizedRCNN(tcfg)
    tm.load_state_dict(params_from_jax(tree), strict=True)
    nb = train_batch()
    del nb["gt_masks"]
    n_props = tcfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN + nb["gt_boxes"].shape[1]
    # anchors of a 128 x 160 batch: (32*40 + 16*20 + 8*10 + 4*5 + 2*3) * 3
    draws = jax_sampler_draws(RNG, nb["images"].shape[0], 5118, n_props)
    return dict(depth=request.param, jm=jm, params=params, tm=tm.eval(), batch=nb, draws=draws)


def test_train_forward_losses_and_gradients_match_jax(setup):
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
    # the body's convs and shortcuts, 8 FPN tensors, 6 of the RPN head,
    # fc6, fc7 and the two predictors with biases
    assert trainable == 3 * sum(BLOCKS[setup["depth"]]) + 3 + 16 + 6 + 8


def test_infer_forward_matches_jax(setup):
    jm, params, tm = setup["jm"], setup["params"], setup["tm"]
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
    assert want["valid"].sum() >= 8
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
