"""The port's training step as a whole against the JAX package's.

The narrow Mask R-CNN R-50-FPN of torch_port_fixtures, the same parameters
and the same padded batch on both sides (float32, CPU), and the samplers'
uniform draws that JAX makes from its key handed to the port
(``jax_sampler_draws``). Tolerances:
  * the five losses rtol 1e-5 (the same samples; sums in another order);
  * each trainable parameter's gradient within 2e-4 * max|JAX gradient| of
    that parameter (float32 convolutions summed in other orders through 16
    residual blocks and back);
  * the parameters after one SGD step rtol 1e-5, atol 1e-7 (the step moves
    them by ~1e-4 of their size, so the gradients' differences vanish);
  * the learning rate at counts 0, 1 and WARMUP_ITERS rtol 1e-6 (float32
    on the JAX side, float64 here).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskrcnn_tpu.engine.train_step import make_train_step as jax_make_train_step
from maskrcnn_tpu.models import build_detection_model as build_jax_model
from maskrcnn_tpu.solver import make_optimizer as jax_make_optimizer
from maskrcnn_tpu.solver.build import warmup_multistep_schedule
from maskrcnn_tpu_torch.engine import make_train_step
from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN
from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer
from maskrcnn_tpu_torch.utils.convert import params_from_jax
from torch_port_fixtures import configs, jax_sampler_draws, numpy_params, train_batch

LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg",
          "loss_mask")
RNG = jax.random.PRNGKey(3)


def _configs():
    """The narrow flagship with the mask ROI cap lowered to 1 per image, so
    that the cross-image compaction of the positives runs."""
    jcfg, tcfg = configs()
    for c in (jcfg, tcfg):
        c.TPU.MASK_ROI_CAP = 1
    return jcfg, tcfg


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _configs()
    jm = build_jax_model(jcfg)
    params = jax.tree.map(jnp.asarray, numpy_params(jm))
    nb = train_batch()
    b = nb["images"].shape[0]
    n_props = tcfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN + nb["gt_boxes"].shape[1]
    # anchors of a 128 x 160 batch: (32*40 + 16*20 + 8*10 + 4*5 + 2*3) * 3
    draws = jax_sampler_draws(RNG, b, 5118, n_props)
    return dict(jm=jm, params=params, tcfg=tcfg, jcfg=jcfg, batch=nb, draws=draws)


def _port_model(setup):
    tm = GeneralizedRCNN(setup["tcfg"])
    tm.load_state_dict(params_from_jax(setup["params"]), strict=True)
    return tm.eval()


def _torch_batch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def _draws(setup):
    return {k: torch.from_numpy(v) for k, v in setup["draws"].items()}


@pytest.fixture(scope="module")
def jax_grads(setup):
    jm, params = setup["jm"], setup["params"]
    batch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}

    def loss_fn(p):
        losses = jm.train_forward(p, batch, RNG)
        return sum(jax.tree.leaves(losses)), losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return {k: float(v) for k, v in losses.items()}, jax.tree.map(np.asarray, grads)


def test_train_forward_losses_and_gradients_match_jax(setup, jax_grads):
    want_losses, want_grads = jax_grads
    tm = _port_model(setup)
    losses = tm.train_forward(_torch_batch(setup["batch"]), draws=_draws(setup))
    assert tuple(losses) == LOSSES and set(want_losses) == set(LOSSES)
    for k in LOSSES:
        np.testing.assert_allclose(losses[k].item(), want_losses[k], rtol=1e-5, err_msg=k)
    assert losses["loss_box_reg"] > 0 and losses["loss_mask"] > 0
    sum(losses.values()).backward()

    want = params_from_jax(want_grads)
    frozen = setup["jm"].frozen_mask(setup["params"])
    frozen = {k for k, v in params_from_jax(jax.tree.map(np.float32, frozen)).items()
              if v.all()}
    trainable = 0
    for name, p in tm.named_parameters():
        assert p.requires_grad == (name not in frozen), name
        if not p.requires_grad:
            assert p.grad is None
            continue
        trainable += 1
        scale = want[name].abs().max().item()
        err = (p.grad - want[name]).abs().max().item()
        assert err <= 2e-4 * scale, (name, err, scale)
    assert trainable == 84


def test_train_step_matches_jax_sgd_step(setup):
    jm, params, jcfg, tcfg = setup["jm"], setup["params"], setup["jcfg"], setup["tcfg"]
    batch = {k: jnp.asarray(v) for k, v in setup["batch"].items()}
    tx, _ = jax_make_optimizer(jcfg, params, jm.frozen_mask(params))
    jstep = jax_make_train_step(jm, tx, donate=False)
    new_params, _, jmetrics = jstep(params, tx.init(params), batch, RNG)

    tm = _port_model(setup)
    opt = make_optimizer(tcfg, tm)
    sched = make_lr_scheduler(tcfg, opt)
    metrics = make_train_step(tm, opt, sched)(_torch_batch(setup["batch"]), draws=_draws(setup))
    for k in LOSSES + ("loss",):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    want = params_from_jax(jax.tree.map(np.asarray, new_params))
    moved = 0
    for name, value in tm.state_dict().items():
        torch.testing.assert_close(value, want[name], rtol=1e-5, atol=1e-7, msg=name)
        moved += not torch.equal(value, params_from_jax(setup["params"])[name])
    # every trainable parameter but the zero biases of the P4 and P5 output
    # convs, which get no gradient here (the anchors of those levels straddle
    # a 128 x 160 image) and no weight decay
    assert moved == 82


def test_lr_schedule_and_parameter_groups_match_jax(setup):
    jcfg, tcfg = setup["jcfg"].clone(), setup["tcfg"].clone()
    for c in (jcfg, tcfg):
        c.SOLVER.WARMUP_ITERS = 5
        c.SOLVER.STEPS = (7,)
    schedule = warmup_multistep_schedule(jcfg)
    tm = _port_model(setup)
    opt = make_optimizer(tcfg, tm)
    sched = make_lr_scheduler(tcfg, opt)
    weights, biases = opt.param_groups
    assert {id(p) for p in biases["params"]} == {
        id(p) for n, p in tm.named_parameters() if p.requires_grad and n.endswith(".bias")}
    assert weights["weight_decay"] == tcfg.SOLVER.WEIGHT_DECAY
    assert biases["weight_decay"] == tcfg.SOLVER.WEIGHT_DECAY_BIAS
    for p in tm.parameters():
        p.grad = torch.zeros_like(p)
    for count in range(9):
        want = float(schedule(count))
        if count in (0, 1, 5, 7, 8):
            np.testing.assert_allclose(weights["lr"], want, rtol=1e-6, err_msg=str(count))
            np.testing.assert_allclose(biases["lr"], want * tcfg.SOLVER.BIAS_LR_FACTOR,
                                       rtol=1e-6)
        opt.step()
        sched.step()
