"""The port's "model" mesh axis on the CPU: output-channel tensor
parallelism over gloo groups of tests/torch_distributed_worker.py
processes, against the JAX package and against one process.

* The layout rule: ``parallel/mesh.py:sharded_dims`` shards exactly the
  leaves that the JAX package's ``tree_shardings`` shards, name for name
  through ``params_from_jax``'s naming and on the dim that JAX's last dim
  becomes, for eight tiny families at model axes 2 and 4 (shapes only:
  ``jax.eval_shape``, nothing compiled).
* The 4-rank (data 2, model 2) step against the JAX train step jitted over
  a 2 x 2 ("data", "model") mesh of CPU devices after ``shard_params``, on
  test_torch_distributed.py's batch, parameters and draws (the keypoint
  model): the losses rtol 1e-5, the gathered gradients within 2e-4 of each
  parameter's max|JAX gradient|, the gathered parameters rtol 1e-5 / atol
  1e-7; the replicated leaves bitwise equal on all four ranks, the blocks
  bitwise equal across each data group, fc6 sharded as JAX's spec says.
* At (data 1, model 2) against one process: the sharded primitives
  (ungrouped, 4 groups, 3 groups that the axis does not divide, depthwise,
  transposed, fc, frozen BN folded), outputs and every gradient at 1e-5 of
  their max; then seven families (X-101 with its grouped convs, mdconv DCN,
  FBNet with its depthwise convs, RetinaNet, GN with the Xconv head, C4,
  and the GN file as written, with the port's GN mask head that JAX lacks):
  the detections (labels exact, scores 1e-5, boxes 1e-3 px), one step's
  losses (rtol 1e-5), gradients (2e-4 of each max) and parameters (rtol
  1e-5 / atol 1e-7). These families are held to JAX through one process:
  the one-process port equals JAX's train_forward, gradients and
  infer_forward in test_torch_faster.py (X-101 32x8d), test_torch_dcn.py
  (mdconv Mask R-CNN), test_torch_fbnet.py, test_torch_retinanet.py,
  test_torch_gn.py (with the Xconv1fc extractor) and test_torch_c4.py; JAX's
  mesh step computes its one-device step, as (b) checks on the keypoint
  model. The GN mask head is held to the benchmark's plain reference
  through one process in test_torch_gn_reference.py.
* Checkpoints: one written under the mesh (by rank 0, the full layout)
  loads in one process (the parameters as above, the momentum, one step's
  gradient, within 2e-4 of its max); one written in one process after a step resumes
  under the mesh, its momentum sharded, and steps as one process does.
* The entry points from a torchrun-style environment of four processes:
  train_net under ("data", "model") / (-1, 2) at a global batch of 2 (the
  data axis divides it, the world does not), a checkpoint at 2 written
  once, a resume to 4 that validates and tests the sharded model; test_net
  under ("model", "data") / (2, -1) gathering what one process predicts,
  each image from model coordinate 0 once; and the refusals: a batch the
  data axis cannot share, a shape that does not fit the processes, an
  unknown axis.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from maskrcnn_tpu.config import cfg as jax_defaults
from maskrcnn_tpu.engine.train_step import make_train_step as jax_make_train_step
from maskrcnn_tpu.models import build_detection_model as build_jax_model
from maskrcnn_tpu.parallel.mesh import (
    create_mesh,
    data_sharding,
    replicated,
    shard_batch,
    shard_params,
    tree_shardings,
)
from maskrcnn_tpu.solver import make_optimizer as jax_make_optimizer
from maskrcnn_tpu_torch.config import cfg as torch_defaults
from maskrcnn_tpu_torch.engine import make_train_step
from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN
from maskrcnn_tpu_torch.parallel import sharded_dims
from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer
from maskrcnn_tpu_torch.tools import test_net
from maskrcnn_tpu_torch.utils.checkpoint import Checkpointer
from maskrcnn_tpu_torch.utils.convert import params_from_jax
from test_models import tiny
from test_torch_distributed import (
    CONFIG,
    LOSSES,
    RNG,
    TEST_OPTS,
    TRAIN_OPTS,
    _coco_tree,
    _spawn,
    _step_setup,
)
from torch_distributed_worker import PRIMITIVES, primitive, primitive_grads
from torch_port_fixtures import jax_sampler_draws, narrow, numpy_tree, train_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FC6 = "roi_heads.box.feature_extractor.fc6.weight"

# family: (config file, overrides after narrow(tiny(...)))
FAMILIES = {
    "flagship": ("e2e_mask_rcnn_R_50_FPN_1x.yaml", {}),
    "x101": ("e2e_faster_rcnn_X_101_32x8d_FPN_1x.yaml",
             {"MODEL.RESNETS.NUM_GROUPS": 4, "MODEL.RESNETS.WIDTH_PER_GROUP": 4}),
    "dcn": ("dcn/e2e_mask_rcnn_mdconv_R_50_FPN_1x.yaml", {}),
    # the mask head without the group norms the JAX package's lacks
    "gn": ("gn_baselines/e2e_mask_rcnn_R_50_FPN_Xconv1fc_1x_gn.yaml",
           {"MODEL.GROUP_NORM.NUM_GROUPS": 2, "MODEL.ROI_BOX_HEAD.CONV_HEAD_DIM": 32,
            "MODEL.ROI_MASK_HEAD.USE_GN": False}),
    "c4": ("e2e_mask_rcnn_R_50_C4_1x.yaml", {"MODEL.RESNETS.BACKBONE_OUT_CHANNELS": 256}),
    "retinanet": ("retinanet/retinanet_R-50-FPN_1x.yaml", {}),
    "keypoint": ("e2e_keypoint_rcnn_R_50_FPN_1x.yaml",
                 {"MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS": (32,) * 8}),
    "fbnet": ("e2e_mask_rcnn_fbnet_xirb16d_dsmask.yaml", {"MODEL.ROI_HEADS.SCORE_THRESH": 0.01}),
}
# families that only the port builds, held to the port in one process: the
# GN file as written, its mask head's group norms included (the JAX package
# ignores ROI_MASK_HEAD.USE_GN, so its tree gives every other leaf)
PORT_FAMILIES = {
    "gn_mask": ("gn_baselines/e2e_mask_rcnn_R_50_FPN_Xconv1fc_1x_gn.yaml",
                {"MODEL.GROUP_NORM.NUM_GROUPS": 2, "MODEL.ROI_BOX_HEAD.CONV_HEAD_DIM": 32}),
}


def _family_cfgs(family):
    """The JAX and port configs of `family`: narrow widths (FBNet keeps
    its own, as tests/test_torch_fbnet.py), float32, no weights."""
    name, overrides = {**FAMILIES, **PORT_FAMILIES}[family]
    jcfg, tcfg = jax_defaults.clone(), torch_defaults.clone()
    for c in (jcfg, tcfg):
        c.merge_from_file(os.path.join(REPO, "configs", name))
        tiny(c)
        if family != "fbnet":
            narrow(c)
        c.TPU.COMPUTE_DTYPE = "float32"
        c.MODEL.WEIGHT = ""
        for key, value in overrides.items():
            node = c
            for part in key.split(".")[:-1]:
                node = getattr(node, part)
            setattr(node, key.split(".")[-1], value)
    return jcfg, tcfg


# -- (a) the layout rule against tree_shardings ------------------------------------------


def _marked(shape, sharded):
    """A leaf of `shape` whose values say where JAX shards it: 1 + its
    index along the last dim when sharded, 0 elsewhere."""
    if not sharded:
        return np.zeros(shape, np.float32)
    return np.broadcast_to(np.arange(1, shape[-1] + 1, dtype=np.float32), shape).copy()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_set_equals_jax_tree_shardings(family):
    jcfg, tcfg = _family_cfgs(family)
    shapes = jax.eval_shape(build_jax_model(jcfg).init, jax.random.PRNGKey(0))
    model = GeneralizedRCNN(tcfg)
    for m in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(8 // m, m), ("data", "model"))
        specs = tree_shardings(shapes, mesh)
        marked = params_from_jax(jax.tree.map(
            lambda s, sh: _marked(s.shape, "model" in tuple(sh.spec)), shapes, specs))
        dims = sharded_dims(model, m)
        assert set(dims) == set(marked)
        sharded = {name for name, t in marked.items() if t.abs().sum() > 0}
        assert sharded == {name for name, d in dims.items() if d is not None}, family
        assert len(sharded) > 10
        for name in sharded:
            t = marked[name].movedim(dims[name], -1)
            rows = t.reshape(-1, t.shape[-1])
            assert torch.equal(rows, torch.arange(1.0, t.shape[-1] + 1).expand_as(rows)), name
        if family == "flagship":
            assert dims[FC6] == 0 and dims["roi_heads.mask.predictor.conv5_mask.weight"] == 1
            # 3 anchors, 81 classes: replicated; 12 box deltas shard at 2 and 4
            assert dims["rpn.cls_logits.weight"] is None and dims["rpn.bbox_pred.weight"] == 0
            assert dims["roi_heads.mask.predictor.mask_fcn_logits.weight"] is None
        if family == "dcn":  # the modulated offset conv's 27 outputs stay whole
            assert all(dims[k] is None for k in dims if "conv2_offset.weight" in k)


# -- (b) the 4-rank (data 2, model 2) step against JAX's 2 x 2 mesh --------------------------


@pytest.mark.timeout(600)
def test_four_rank_mesh_step_equals_the_jax_two_by_two_mesh_step(tmp_path):
    jcfg, tcfg, jm, params, nb, draws = _step_setup(keypoints=True)
    losses = LOSSES + ("loss_kp",)
    jparams = jax.tree.map(jnp.asarray, params)
    dp = create_mesh(devices=jax.devices()[:2])
    batch_dp = shard_batch({k: jnp.asarray(v) for k, v in nb.items()}, dp)

    def loss_fn(p, b):
        out = jm.train_forward(p, b, RNG)
        return sum(jax.tree.leaves(out)), out

    _, jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                        in_shardings=(replicated(dp), data_sharding(dp)),
                        out_shardings=replicated(dp))(jparams, batch_dp)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    spec = tree_shardings(jparams, mesh)["roi_heads"]["box"]["feature_extractor"]["fc6"]["w"].spec
    assert tuple(spec) == (None, "model")
    tx, _ = jax_make_optimizer(jcfg, jparams, jm.frozen_mask(jparams))
    jstep = jax_make_train_step(jm, tx, mesh, donate=False)
    new_params, _, jmetrics = jstep(
        shard_params(jparams, mesh), shard_params(tx.init(jparams), mesh),
        shard_batch({k: jnp.asarray(v) for k, v in nb.items()}, mesh), RNG)

    res = _spawn("mesh_step", 4, str(tmp_path), job={
        "cfg": tcfg._to_plain(), "state": params_from_jax(params), "batch": nb, "draws": draws,
        "shape": (-1, 2)})
    assert [r["coords"] for r in res] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    want_grads = params_from_jax(jax.tree.map(np.asarray, jgrads))
    want_params = params_from_jax(jax.tree.map(np.asarray, new_params))
    for r in res:
        for k in losses + ("loss",):
            np.testing.assert_allclose(r["metrics"][k], float(jmetrics[k]), rtol=1e-5, err_msg=k)
        assert len(r["grads"]) == 84 + 18
        for name, g in r["grads"].items():
            scale = want_grads[name].abs().max().item()
            if name.endswith("kps_score_lowres.bias"):  # zero but for rounding, as there
                wscale = want_grads[name.replace("bias", "weight")].abs().max().item()
                assert max(scale, g.abs().max().item()) <= 1e-4 * wscale, name
                continue
            assert (g - want_grads[name]).abs().max().item() <= 2e-4 * scale, name
        for name, value in r["params"].items():
            torch.testing.assert_close(value, want_params[name], rtol=1e-5, atol=1e-7, msg=name)
        assert r["dims"][FC6] == 0 and r["local"][FC6].shape[0] * 2 == want_params[FC6].shape[0]
    for name in res[0]["local"]:
        if name in res[0]["dims"]:  # each data group's blocks alike, the two blocks apart
            assert torch.equal(res[0]["local"][name], res[2]["local"][name]), name
            assert torch.equal(res[1]["local"][name], res[3]["local"][name]), name
        else:
            assert all(torch.equal(r["local"][name], res[0]["local"][name]) for r in res), name
    assert len(res[0]["dims"]) > 50


# -- (c, d) the families, the primitives and checkpoints at (data 1, model 2) ---------------


def _family_job(family, seed):
    jcfg, tcfg = _family_cfgs(family)
    jm = build_jax_model(jcfg)
    tree = numpy_tree(jm, seed)
    if not tcfg.MODEL.RETINANET_ON:  # class scores spread over a few classes
        pred = tree["roi_heads"]["box"]["predictor"]
        rs = np.random.RandomState(seed + 1)
        pred["cls_score"]["w"] = rs.normal(0, 0.3, pred["cls_score"]["w"].shape).astype(np.float32)
    state = params_from_jax(tree)
    nb = train_batch(seed)
    if not tcfg.MODEL.MASK_ON or tcfg.MODEL.RETINANET_ON:
        del nb["gt_masks"]
    model = GeneralizedRCNN(tcfg)
    if family in PORT_FAMILIES:
        state = _port_leaves(state, model, seed)
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        anchors = sum(a.shape[0] for a in model._backbone(
            {k: torch.from_numpy(v) for k, v in nb.items()})[1])
    draws = {}
    if not tcfg.MODEL.RETINANET_ON:
        slots = tcfg.MODEL.RPN.POST_NMS_TOP_N_TRAIN if tcfg.MODEL.BACKBONE.CONV_BODY in (
            "R-50-C4", "FBNet") else tcfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN
        draws = jax_sampler_draws(RNG, 2, anchors, slots + nb["gt_boxes"].shape[1])
    rs = np.random.RandomState(seed + 2)
    infer = {"images": rs.randint(0, 256, (2, 128, 160, 3)).astype(np.uint8),
             "image_sizes": np.array([[128, 160], [112, 136]], np.int32)}
    return {"name": family, "cfg": tcfg._to_plain(), "state": state, "batch": nb,
            "draws": draws, "infer": infer}


def _port_leaves(state, model, seed):
    """`state` (the JAX tree's) for a model of the port's own: the leaves
    JAX lacks, only group norms here, at scale U(0.5, 1.5), bias
    U(-0.2, 0.2); those the port's model lacks (a GN conv's bias) dropped."""
    rs = np.random.RandomState(seed + 3)
    want = model.state_dict()
    out = {k: v for k, v in state.items() if k in want}
    for name in sorted(set(want) - set(out)):
        assert name.endswith((".gn.scale", ".gn.bias")), name
        lo, hi = (0.5, 1.5) if name.endswith("scale") else (-0.2, 0.2)
        out[name] = torch.from_numpy(rs.uniform(lo, hi, want[name].shape).astype(np.float32))
    return out


def _one_process(job, steps=1):
    from maskrcnn_tpu_torch.config.cfgnode import CfgNode

    cfg = CfgNode(job["cfg"])
    model = GeneralizedRCNN(cfg)
    model.load_state_dict(job["state"], strict=True)
    model.eval()
    opt = make_optimizer(cfg, model)
    sched = make_lr_scheduler(cfg, opt)
    det = model.infer_forward({k: torch.from_numpy(v) for k, v in job["infer"].items()})
    step = make_train_step(model, opt, sched)
    batch = {k: torch.from_numpy(v) for k, v in job["batch"].items()}
    draws = {k: torch.from_numpy(v) for k, v in job["draws"].items()}
    for _ in range(steps):
        metrics = step(batch, draws=draws)
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return model, opt, sched, det, {k: v.item() for k, v in metrics.items()}, grads


def _close_step(got, want_metrics, want_params, want_grads=None):
    for k, v in want_metrics.items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)
    for name, value in got["params"].items():
        torch.testing.assert_close(value, want_params[name], rtol=1e-5, atol=1e-7, msg=name)
    if want_grads is not None:
        assert set(got["grads"]) == set(want_grads)
        for name, g in got["grads"].items():
            scale = want_grads[name].abs().max().item()
            assert (g - want_grads[name]).abs().max().item() <= 2e-4 * scale, name


def _same_detections(got, want):
    assert set(got) == set(want)
    v = want["valid"].numpy()
    assert v.sum() >= 4 and np.array_equal(got["valid"].numpy(), v)
    np.testing.assert_array_equal(got["labels"].numpy()[v], want["labels"].numpy()[v])
    np.testing.assert_allclose(got["scores"].numpy()[v], want["scores"].numpy()[v], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy()[v], want["boxes"].numpy()[v], rtol=0,
                               atol=1e-3)


MESH_FAMILIES = ("x101", "dcn", "fbnet", "retinanet", "gn", "c4", "gn_mask")


@pytest.mark.timeout(600)
def test_families_and_checkpoints_under_a_model_axis_of_two_equal_one_process(tmp_path):
    jobs = [_family_job(f, seed) for seed, f in enumerate(MESH_FAMILIES)]
    # the flagship after one step of one process, momentum and all, to resume
    flagship = _family_job("flagship", 7)
    model, opt, sched, _, _, _ = _one_process(flagship)
    ckpt = tmp_path / "one" / "model_0000001.pth"
    Checkpointer(model, opt, sched, str(tmp_path / "one")).save("model_0000001", iteration=1)
    metrics = make_train_step(model, opt, sched)(
        {k: torch.from_numpy(v) for k, v in flagship["batch"].items()},
        draws={k: torch.from_numpy(v) for k, v in flagship["draws"].items()})
    resumed_params = {k: v.clone() for k, v in model.state_dict().items()}
    resumed_metrics = {k: v.item() for k, v in metrics.items()}

    res = _spawn("mesh_families", 2, str(tmp_path / "work"), job={
        "families": jobs, "resume": dict(flagship, file=str(ckpt))})
    for name in PRIMITIVES:
        box, x, w = primitive(name)
        want = primitive_grads(name, box, x, w)
        for r in res:
            got = r["primitives"][name]
            assert got["dims"] == {"m.weight": 1 if name == "transposed" else 0}, name
            assert set(got) - {"dims"} == set(want)
            for k, v in want.items():
                err = (got[k] - v).abs().max().item()
                assert err <= 1e-5 * v.abs().max().item(), (name, k, err)
    for job in jobs:
        model, opt, _, det, metrics, grads = _one_process(job)
        params = model.state_dict()
        for rank, r in enumerate(res):
            got = r[job["name"]]
            assert got["dims"], job["name"]
            _same_detections(got["det"], det)
            _close_step(got, metrics, params, grads)
        # written by rank 0 at the full layout, read in one process
        saved = torch.load(tmp_path / "work" / job["name"] / "model_0000001.pth",
                           weights_only=True)
        assert saved["iteration"] == 1
        fresh = GeneralizedRCNN(model.cfg)
        fresh.load_state_dict(saved["model"], strict=True)
        opt2 = make_optimizer(model.cfg, fresh)
        opt2.load_state_dict(saved["optimizer"])
        for name, value in fresh.state_dict().items():
            torch.testing.assert_close(value, params[name], rtol=1e-5, atol=1e-7, msg=name)
        want_state = opt.state_dict()["state"]
        assert set(saved["optimizer"]["state"]) == set(want_state)
        for idx, s in saved["optimizer"]["state"].items():  # the first step's gradient
            want = want_state[idx]["momentum_buffer"]
            err = (s["momentum_buffer"] - want).abs().max().item()
            assert err <= 2e-4 * want.abs().max().item(), idx
    for r in res:
        assert r["resumed"]["extra"] == {"iteration": 1}
        _close_step(r["resumed"], resumed_metrics, resumed_params)
    assert set(res[0]["x101"]["dims"]) >= {"backbone.body.layer2.0.conv2.weight"}


# -- (e) train_net and test_net under (data 2, model 2) -------------------------------------


@pytest.mark.timeout(600)
def test_train_net_and_test_net_under_a_two_by_two_mesh(tmp_path, monkeypatch):
    data_root = _coco_tree(tmp_path, 6, ("train2017", "val2017"))
    out = tmp_path / "out"
    train_args = ["--config-file", CONFIG] + TRAIN_OPTS + [
        "DATASETS.TEST", "('coco_2017_val',)", "TEST.IMS_PER_BATCH", "2",
        "OUTPUT_DIR", str(out)]
    test_args = ["--config-file", CONFIG, "--ckpt", str(out / "model_final.pth")] + TEST_OPTS
    res = _spawn("mesh_entry", 4, str(tmp_path / "work"), torchrun_env=True, job={
        "train_args": train_args, "test_args": test_args + ["OUTPUT_DIR", str(tmp_path / "four")]},
        MASKRCNN_TPU_DATA_DIR=str(data_root))
    # ("data", "model") / (-1, 2) puts ranks 0, 1 on data coordinate 0;
    # ("model", "data") / (2, -1) puts ranks 0, 2 there
    assert [r["coords"] for r in res] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["test_coords"] for r in res] == [(0, 0), (1, 0), (0, 1), (1, 1)]
    for rank, r in enumerate(res):
        saves = [line for line in r["first"] if line.startswith("Saving checkpoint")]
        assert saves == ([] if rank else ["Saving checkpoint to {}".format(out / name) for name in
                                          ("model_0000002.pth", "model_final.pth")]), saves
        assert "Loading checkpoint from {}".format(out / "model_final.pth") in r["second"]
        assert all(np.isfinite(v) for v in r["losses"].values()) and len(r["losses"]) == 6
        assert r["caught"] == [
            "SOLVER.IMS_PER_BATCH (3) must be divisible by the data-parallel mesh size (2)",
            "TPU.MESH_AXES ('data', 'model') / MESH_SHAPE (3, -1) does not fit the 4 "
            "process(es)",
            "TPU.MESH_AXES ('data', 'pipe') / MESH_SHAPE (-1, 2): the axes are \"data\" and "
            "\"model\", one size each"]
        # validation at 4 and the final test: each image from model coordinate 0 once
        assert len(r["train_gathered"]) == 2
        for shards, idle in [(s, (1, 3)) for s in r["train_gathered"]] + [
                (s, (2, 3)) for s in r["test_gathered"]]:
            assert sorted(i for s in shards for i in s) == list(range(6))
            assert all(s for q, s in enumerate(shards) if q not in idle)
            assert not any(shards[q] for q in idle)
        assert (r["results"] is None) == (rank > 0)
        for name, value in r["state"].items():  # the gathered model is the checkpoint's
            assert torch.equal(value, res[0]["state"][name]), name
    final = torch.load(out / "model_final.pth", weights_only=True)
    assert final["iteration"] == 4
    assert all(torch.equal(final["model"][k], v) for k, v in res[0]["state"].items())

    # test_net of one process on the same weights
    monkeypatch.setenv("MASKRCNN_TPU_DATA_DIR", str(data_root))
    ((one, _),) = test_net.main(test_args + ["OUTPUT_DIR", str(tmp_path / "one")])
    (four,) = res[0]["results"]
    preds = []
    for side in ("one", "four"):
        with open(tmp_path / side / "inference" / "coco_2017_val" / "predictions.pkl", "rb") as f:
            preds.append(pickle.load(f))
    assert len(preds[0]) == len(preds[1]) == 6 and sum(len(p) for p in preds[0]) >= 6
    for a, b in zip(*preds):
        assert a.size == b.size and len(a) == len(b)
        np.testing.assert_array_equal(a.get_field("labels"), b.get_field("labels"))
        np.testing.assert_allclose(a.get_field("scores"), b.get_field("scores"), rtol=0, atol=1e-5)
        np.testing.assert_allclose(a.bbox, b.bbox, rtol=0, atol=1e-3)
    for k, v in one.results["bbox"].items():
        assert abs(four["bbox"][k] - v) <= 1e-6, (k, four["bbox"][k], v)
