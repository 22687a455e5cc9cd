"""The port's multi-process path on the CPU: gloo groups of 2 (and 4)
processes, each a tests/torch_distributed_worker.py, against the JAX
package and against one process.

* ``utils/comm.py``'s collectives at world sizes 2 and 4, and their
  one-process identities.
* ``data/samplers.py:DistributedSampler`` against the JAX package's, index
  list for index list.
* The 2-rank global-batch train step against the JAX package's train step
  jitted over a 2-device mesh (2 of the 8 CPU devices of tests/conftest.py)
  on the same global batch, parameters and draws: the losses rtol 1e-5, the
  gradients within 2e-4 of each parameter's max|JAX gradient|, the updated
  parameters rtol 1e-5 / atol 1e-7 (test_torch_train.py's tolerances), and
  the two ranks' parameters bitwise equal. The batch's per-rank mask
  positives differ and the global FPN k-th score differs from each rank's;
  the test asserts both, and that a plain DDP port (per-rank k-th score,
  denominators and mask cap, losses averaged) is off by far more than the
  tolerance. Its model has a keypoint head too, whose batch-wide cap cuts
  the positives by their place in the global batch as the mask head's.
* A RetinaNet's 2-rank step (float32) against one process's step on the
  global batch: losses rtol 1e-5, gradients within 2e-4 of each
  parameter's max, the focal loss's and smooth-L1's denominators (the
  positives and the images) the global batch's.
* do_train's global decision to skip a batch without gt.
* train_net under 2 ranks from a torchrun-style environment: rank 0 alone
  writes the checkpoints, both resume from model_final.
* test_net under 2 ranks on 5 images (the sampler pads the second shard):
  rank 0's gathered predictions equal one process's (labels exact, scores
  1e-5, boxes 1e-3 px); rank 1 returns None.
* What the multi-process path refuses: a batch the ranks cannot share,
  WORLD_SIZE=2 with an unreachable master, the tensor-parallel mesh axis.
"""

import os
import pickle
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from maskrcnn_tpu.data.samplers import DistributedSampler as JaxDistributedSampler
from maskrcnn_tpu.engine.train_step import make_train_step as jax_make_train_step
from maskrcnn_tpu.models import build_detection_model as build_jax_model
from maskrcnn_tpu.parallel.mesh import (
    create_mesh,
    data_sharding,
    replicate,
    replicated,
    shard_batch,
)
from maskrcnn_tpu.solver import make_optimizer as jax_make_optimizer
from maskrcnn_tpu_torch.config import flagship_cfg
from maskrcnn_tpu_torch.data.samplers import DistributedSampler
from maskrcnn_tpu_torch.parallel import init_distributed
from maskrcnn_tpu_torch.tools import test_net
from maskrcnn_tpu_torch.utils import comm
from maskrcnn_tpu_torch.utils.convert import params_from_jax
from synthetic_coco import make_synthetic_coco
from torch_port_fixtures import configs, jax_sampler_draws, numpy_params, train_batch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_distributed_worker.py")
CONFIG = os.path.join(REPO, "configs", "e2e_mask_rcnn_R_50_FPN_1x.yaml")
LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg",
          "loss_mask")
RNG = jax.random.PRNGKey(3)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2", **extra)
    env["PYTHONPATH"] = os.pathsep.join([REPO, HERE, env.get("PYTHONPATH", "")])
    return env


def _spawn(task, world, out, job=None, torchrun_env=False, timeout=400, **env):
    """Run `task` in `world` worker processes; returns what each rank
    wrote, by rank."""
    os.makedirs(out, exist_ok=True)
    if job is not None:
        torch.save(job, os.path.join(out, "job.pt"))
    port = _free_port()
    procs = []
    for rank in range(world):
        penv = _env(**env)
        if torchrun_env:
            penv.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                        MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, task, str(rank), str(world), str(port), str(out)],
            env=penv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, log) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "WORKER_OK {}".format(rank) in log, (
            "rank {} of {} failed:\n{}".format(rank, task, log[-4000:]))
    return [torch.load(os.path.join(out, "{}_rank{}.pt".format(task, r)), weights_only=False)
            for r in range(world)]


@pytest.mark.timeout(300)
@pytest.mark.parametrize("world", [2, 4])
def test_comm_collectives_and_their_one_process_identities(tmp_path, world):
    res = _spawn("comm", world, str(tmp_path))
    mine = torch.stack([r["mine"] for r in res])
    for got in res:
        assert got["mean"] == {"loss": (world - 1) / 2, "n": float(world - 1)}
        assert got["total"] == {"loss": float(sum(range(world)))}
        assert torch.equal(got["rows"], mine)
        assert int(got["global_sum"]) == world * (world + 1) // 2
        assert got["int_rows"].tolist() == [[q, -q] for q in range(world)]
    # without a group: the identities, and no collective
    t = torch.arange(6.0).reshape(2, 3)
    assert comm.get_world_size() == 1 and comm.get_rank() == 0
    assert comm.all_gather({"a": 1}) == [{"a": 1}]
    assert comm.reduce_dict({"l": torch.tensor(1.5)}) == {"l": 1.5}
    assert comm.global_sum(t) is t
    assert torch.equal(comm.gather_rows(t), t[None])
    assert comm.synchronize() is None


def test_distributed_sampler_gives_the_jax_index_lists():
    class Sized:
        def __init__(self, n):
            self.n = n

        def __len__(self):
            return self.n

    cases = 0
    for n in (1, 5, 11, 16):
        for replicas in (1, 2, 3, 4):
            for shuffle in (True, False):
                for epoch in (0, 3):
                    shards = []
                    for rank in range(replicas):
                        ours = DistributedSampler(Sized(n), replicas, rank, shuffle=shuffle)
                        theirs = JaxDistributedSampler(Sized(n), replicas, rank, shuffle=shuffle)
                        ours.set_epoch(epoch)
                        theirs.set_epoch(epoch)
                        assert list(ours) == list(theirs) and len(ours) == len(theirs)
                        shards.append(list(ours))
                        cases += 1
                    if n >= replicas:  # padding repeats at most the n indices
                        assert len({len(s) for s in shards}) == 1
                        assert set(i for s in shards for i in s) == set(range(n))
    assert cases == 4 * 10 * 2 * 2


MASK_ROI_CAP = 3
KEYPOINT_ROI_CAP = 2


def _step_setup(keypoints=False):
    """test_torch_train.py's batch of two images and JAX's draws, on the
    narrow flagship with the mask ROI cap lowered to 3 per image: the box
    sampler gives the images 4 and 3 positives, so the batch-wide cap of 6
    binds and keeps 4 on rank 0 and 2 on rank 1 (a per-rank cap: 3 and 3).
    With keypoints=True the model has a keypoint head too (8 convs of 32),
    its ROI cap at 2 per image: the batch-wide 4 keeps rank 0's 4 positives
    and none of rank 1's; every gt has visible joints inside its box, so
    the box sampler keeps the same positives."""
    jcfg, tcfg = configs()
    for c in (jcfg, tcfg):
        c.TPU.MASK_ROI_CAP = MASK_ROI_CAP
        if keypoints:
            c.MODEL.KEYPOINT_ON = True
            c.TPU.KEYPOINT_ROI_CAP = KEYPOINT_ROI_CAP
            c.MODEL.ROI_KEYPOINT_HEAD.POOLER_SCALES = (0.25, 0.125, 0.0625, 0.03125)
            c.MODEL.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO = 2
            c.MODEL.ROI_KEYPOINT_HEAD.CONV_LAYERS = (32,) * 8
    jm = build_jax_model(jcfg)
    params = numpy_params(jm)
    nb = train_batch()
    if keypoints:
        rs = np.random.RandomState(5)
        gt = nb["gt_boxes"]
        xy = rs.uniform(gt[..., None, :2], gt[..., None, 2:], gt.shape[:2] + (17, 2))
        nb["gt_keypoints"] = np.concatenate(
            [xy, np.full(gt.shape[:2] + (17, 1), 2.0)], -1).astype(np.float32)
        nb["gt_keypoints"][nb["gt_labels"] == 0] = 0
    n_props = tcfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN + nb["gt_boxes"].shape[1]
    draws = jax_sampler_draws(RNG, 2, 5118, n_props)
    return jcfg, tcfg, jm, params, nb, draws


def _kept(scores, kth):
    return int((scores >= max(kth, -5e9)).sum())


@pytest.mark.timeout(600)
def test_two_rank_step_equals_the_jax_two_device_mesh_step(tmp_path):
    jcfg, tcfg, jm, params, nb, draws = _step_setup(keypoints=True)
    losses = LOSSES + ("loss_kp",)
    mesh = create_mesh(devices=jax.devices()[:2])
    jparams = jax.tree.map(jnp.asarray, params)
    batch = shard_batch({k: jnp.asarray(v) for k, v in nb.items()}, mesh)

    def loss_fn(p, b):
        losses = jm.train_forward(p, b, RNG)
        return sum(jax.tree.leaves(losses)), losses

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                      in_shardings=(replicated(mesh), data_sharding(mesh)),
                      out_shardings=replicated(mesh))
    (_, jlosses), jgrads = grad_fn(jparams, batch)
    tx, _ = jax_make_optimizer(jcfg, jparams, jm.frozen_mask(jparams))
    jstep = jax_make_train_step(jm, tx, mesh, donate=False)
    new_params, _, jmetrics = jstep(replicate(jparams, mesh), replicate(tx.init(jparams), mesh),
                                    batch, RNG)

    res = _spawn("step", 2, str(tmp_path), job={
        "cfg": tcfg._to_plain(), "state": params_from_jax(params), "batch": nb, "draws": draws})
    want_grads = params_from_jax(jax.tree.map(np.asarray, jgrads))
    want_params = params_from_jax(jax.tree.map(np.asarray, new_params))
    for r in res:
        for k in losses + ("loss",):
            np.testing.assert_allclose(r["metrics"][k], float(jmetrics[k]), rtol=1e-5, err_msg=k)
        for k in losses:
            np.testing.assert_allclose(r["metrics"][k], float(jlosses[k]), rtol=1e-5, err_msg=k)
        # the mask model's 84, and the keypoint head's 8 convs and deconv
        assert len(r["grads"]) == 84 + 18
        for name, g in r["grads"].items():
            scale = want_grads[name].abs().max().item()
            err = (g - want_grads[name]).abs().max().item()
            if name.endswith("kps_score_lowres.bias"):
                # zero but for rounding (a spatial softmax's gradient sums to
                # zero over its bins): held to the deconv weight's, as in
                # tests/test_torch_keypoint.py
                wscale = want_grads[name.replace("bias", "weight")].abs().max().item()
                assert max(scale, g.abs().max().item()) <= 1e-4 * wscale, name
                continue
            assert err <= 2e-4 * scale, (name, err, scale)
        for name, value in r["params"].items():
            torch.testing.assert_close(value, want_params[name], rtol=1e-5, atol=1e-7, msg=name)
    assert all(torch.equal(res[0]["params"][k], v) for k, v in res[1]["params"].items())

    # the batch exercises what makes the step global: the FPN k-th score of
    # the global batch keeps other proposals on each rank than each rank's own
    k = tcfg.MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN
    kept_global, kept_local = [], []
    for r in res:
        local, gathered = r["record"]["gather_rows"][0]
        assert gathered.shape == (2,) + tuple(local.shape)
        kth_global = torch.topk(gathered.reshape(-1), min(k, gathered.numel())).values[-1]
        kth_local = torch.topk(local.reshape(-1), min(k, local.numel())).values[-1]
        kept_global.append(_kept(local, kth_global))
        kept_local.append(_kept(local, kth_local))
    assert kept_global != kept_local and sum(kept_global) == k, (kept_global, kept_local)
    # the mask head's positives differ by rank, and so does its denominator;
    # the batch-wide cap cuts them
    (valid_r0, _), (valid_r1, _) = (r["record"]["gather_rows"][1] for r in res)
    mask_counts = [int(r["record"]["global_sum"][-2][0]) for r in res]
    assert [int(valid_r0[0]), int(valid_r1[0])] == [4, 3]
    assert mask_counts == [4, 2] and sum(mask_counts) == 2 * MASK_ROI_CAP, mask_counts
    # the keypoint head's cap over the same positives: rank 0 keeps its 4,
    # rank 1 none, and the loss divides by the joints of both ranks' rows
    (kp_r0, _), (kp_r1, _) = (r["record"]["gather_rows"][2] for r in res)
    assert [int(kp_r0[0]), int(kp_r1[0])] == [4, 3]
    joints = [int(r["record"]["global_sum"][-1][0]) for r in res]
    assert joints[0] > 0 and joints[1] == 0, joints
    # a plain DDP port would have failed: its box losses are off by far more
    # than the tolerance (its mask loss only by ~1e-5 here: at this init
    # every pixel's BCE is near log 2, whichever positives are kept)
    ddp = res[0]["ddp_losses"]
    errs = {k: abs(ddp[k] - float(jmetrics[k])) / abs(float(jmetrics[k])) for k in losses}
    assert errs["loss_box_reg"] > 1e-2 and errs["loss_classifier"] > 1e-3, errs


@pytest.mark.timeout(300)
def test_two_rank_retinanet_step_equals_one_process(tmp_path):
    from maskrcnn_tpu.config import cfg as jax_defaults
    from maskrcnn_tpu_torch.config import cfg as torch_defaults
    from maskrcnn_tpu_torch.engine import make_train_step
    from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN
    from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer
    from test_models import tiny
    from torch_port_fixtures import narrow, numpy_tree

    yaml = os.path.join(REPO, "configs", "retinanet", "retinanet_R-50-FPN_1x.yaml")
    jcfg, tcfg = jax_defaults.clone(), torch_defaults.clone()
    for c in (jcfg, tcfg):
        c.merge_from_file(yaml)
        narrow(tiny(c))
        c.MODEL.WEIGHT = ""
    state = params_from_jax(numpy_tree(build_jax_model(jcfg)))
    nb = train_batch()
    del nb["gt_masks"]
    res = _spawn("step", 2, str(tmp_path), job={
        "cfg": tcfg._to_plain(), "state": state, "batch": nb, "draws": {}})

    model = GeneralizedRCNN(tcfg)
    model.load_state_dict(state, strict=True)
    opt = make_optimizer(tcfg, model)
    metrics = make_train_step(model, opt, make_lr_scheduler(tcfg, opt))(
        {k: torch.from_numpy(v) for k, v in nb.items()})
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    assert len(grads) == 78
    for r in res:
        assert set(r["metrics"]) == {"loss_retina_cls", "loss_retina_reg", "loss"}
        for k, v in metrics.items():
            np.testing.assert_allclose(r["metrics"][k], v.item(), rtol=1e-5, err_msg=k)
        assert set(r["grads"]) == set(grads)
        for name, g in r["grads"].items():
            scale = grads[name].abs().max().item()
            assert (g - grads[name]).abs().max().item() <= 2e-4 * scale, name
        # the denominators: positives and images over both ranks
        (_, pos), (_, images) = r["record"]["global_sum"]
        assert int(images) == 2 and int(pos) > 0
    assert all(torch.equal(res[0]["params"][k], v) for k, v in res[1]["params"].items())


@pytest.mark.timeout(300)
def test_a_batch_is_skipped_only_when_no_rank_has_gt(tmp_path):
    _, tcfg, _, params, nb, _ = _step_setup()
    res = _spawn("skip", 2, str(tmp_path), job={
        "cfg": tcfg._to_plain(), "state": params_from_jax(params), "batch": nb})
    for r in res:
        # stepped at 1 and at 2 (rank 1 alone without gt), skipped 3 (none)
        assert (r["steps"], r["skipped"], r["iteration"]) == (2, [3], 3), r
    assert all(torch.equal(res[0]["params"][k], v) for k, v in res[1]["params"].items())


TRAIN_OPTS = [
    "MODEL.DEVICE", "cpu", "MODEL.WEIGHT", "", "MODEL.ROI_BOX_HEAD.NUM_CLASSES", "4",
    "DATASETS.TRAIN", "('coco_2017_train',)", "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
    "MODEL.RESNETS.STEM_OUT_CHANNELS", "16", "MODEL.RESNETS.WIDTH_PER_GROUP", "16",
    "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", "32", "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64",
    "MODEL.ROI_MASK_HEAD.CONV_LAYERS", "(32, 32, 32, 32)", "TPU.COMPUTE_DTYPE", "float32",
    "INPUT.PIXEL_STD", "[57.375, 57.12, 58.395]", "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", "200",
    "MODEL.RPN.POST_NMS_TOP_N_TRAIN", "100", "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", "128",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "64", "INPUT.MIN_SIZE_TRAIN", "(120,)",
    "INPUT.MAX_SIZE_TRAIN", "160", "SOLVER.IMS_PER_BATCH", "2", "SOLVER.BASE_LR", "0.0001",
    "TPU.MAX_GT_BOXES", "8", "DATALOADER.NUM_WORKERS", "0", "SOLVER.CHECKPOINT_PERIOD", "2",
]


def _coco_tree(tmp_path, num_images, splits, seed=0):
    root = tmp_path / "datasets"
    img_dir, ann_file = make_synthetic_coco(str(tmp_path / "gen"), num_images=num_images,
                                            num_classes=3, seed=seed)
    (root / "coco" / "annotations").mkdir(parents=True)
    for split in splits:
        shutil.copytree(img_dir, str(root / "coco" / split))
        shutil.copy(ann_file, str(root / "coco" / "annotations" / "instances_{}.json".format(split)))
    return root


@pytest.mark.timeout(400)
def test_train_net_under_two_ranks_writes_once_and_resumes_on_both(tmp_path):
    data_root = _coco_tree(tmp_path, 6, ("train2017",))
    out = tmp_path / "out"
    args = ["--config-file", CONFIG, "--skip-test"] + TRAIN_OPTS + ["OUTPUT_DIR", str(out)]
    res = _spawn("train_net", 2, str(tmp_path / "work"), job={"args": args}, torchrun_env=True,
                 MASKRCNN_TPU_DATA_DIR=str(data_root))
    for rank, r in enumerate(res):
        assert (r["world"], r["backend"]) == (2, "gloo")
        saves = [line for line in r["first"] if line.startswith("Saving checkpoint")]
        assert saves == ([] if rank else ["Saving checkpoint to {}".format(out / name) for name in
                                          ("model_0000002.pth", "model_final.pth")]), saves
        assert "Loading checkpoint from {}".format(out / "model_final.pth") in r["second"]
        assert all(np.isfinite(v) for v in r["losses"].values()) and len(r["losses"]) == 6
    assert "Using 2 processes" in res[0]["first"]
    assert any("iter: 4" in line for line in res[0]["second"])
    assert torch.load(out / "model_final.pth", weights_only=True)["iteration"] == 4
    assert all(torch.equal(res[0]["params"][k], v) for k, v in res[1]["params"].items())


TEST_OPTS = [
    "MODEL.DEVICE", "cpu", "MODEL.ROI_BOX_HEAD.NUM_CLASSES", "4",
    "DATASETS.TEST", "('coco_2017_val',)", "MODEL.RESNETS.RES2_OUT_CHANNELS", "64",
    "MODEL.RESNETS.STEM_OUT_CHANNELS", "16", "MODEL.RESNETS.WIDTH_PER_GROUP", "16",
    "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", "32", "MODEL.ROI_BOX_HEAD.MLP_HEAD_DIM", "64",
    "MODEL.ROI_MASK_HEAD.CONV_LAYERS", "(32, 32, 32, 32)", "TPU.COMPUTE_DTYPE", "float32",
    "INPUT.PIXEL_STD", "[57.375, 57.12, 58.395]", "MODEL.RPN.PRE_NMS_TOP_N_TEST", "200",
    "MODEL.RPN.POST_NMS_TOP_N_TEST", "100", "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", "100",
    "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", "10", "MODEL.ROI_HEADS.SCORE_THRESH", "0.01",
    "INPUT.MIN_SIZE_TEST", "120", "INPUT.MAX_SIZE_TEST", "160", "TEST.IMS_PER_BATCH", "2",
    "DATALOADER.NUM_WORKERS", "0",
]


@pytest.mark.timeout(400)
def test_test_net_under_two_ranks_gathers_what_one_process_predicts(tmp_path, monkeypatch):
    data_root = _coco_tree(tmp_path, 5, ("val2017",), seed=2)
    jcfg, _ = configs()
    jcfg.MODEL.ROI_BOX_HEAD.NUM_CLASSES = 4
    weights = tmp_path / "weights.pth"
    torch.save({"model": params_from_jax(numpy_params(build_jax_model(jcfg)))}, weights)
    args = ["--config-file", CONFIG, "--ckpt", str(weights)] + TEST_OPTS

    monkeypatch.setenv("MASKRCNN_TPU_DATA_DIR", str(data_root))
    ((one, _),) = test_net.main(args + ["OUTPUT_DIR", str(tmp_path / "one")])
    res = _spawn("test_net", 2, str(tmp_path / "work"),
                 job={"args": args + ["OUTPUT_DIR", str(tmp_path / "two")]},
                 MASKRCNN_TPU_DATA_DIR=str(data_root))
    assert res[1]["results"] is None
    (two,) = res[0]["results"]
    assert set(two) == {"bbox", "segm"}
    preds = []
    for side in ("one", "two"):
        with open(tmp_path / side / "inference" / "coco_2017_val" / "predictions.pkl", "rb") as f:
            preds.append(pickle.load(f))
    assert len(preds[0]) == len(preds[1]) == 5
    assert sum(len(p) for p in preds[0]) >= 10
    for a, b in zip(*preds):
        assert a.size == b.size and len(a) == len(b)
        np.testing.assert_array_equal(a.get_field("labels"), b.get_field("labels"))
        np.testing.assert_allclose(a.get_field("scores"), b.get_field("scores"), rtol=0, atol=1e-5)
        np.testing.assert_allclose(a.bbox, b.bbox, rtol=0, atol=1e-3)
    for k, v in one.results["bbox"].items():
        assert abs(two["bbox"][k] - v) <= 1e-6, (k, two["bbox"][k], v)


@pytest.mark.timeout(300)
def test_uneven_batches_an_unreachable_master_and_the_model_axis_raise(tmp_path, monkeypatch):
    out = ["OUTPUT_DIR", str(tmp_path / "out")]
    res = _spawn("refuse", 2, str(tmp_path), job={
        "train_args": ["--config-file", CONFIG, "--skip-test"] + TRAIN_OPTS + out,
        "test_args": ["--config-file", CONFIG, "MODEL.WEIGHT", ""] + TEST_OPTS + out})
    for r in res:
        assert r["caught"] == [
            "SOLVER.IMS_PER_BATCH (3) must be divisible by the data-parallel mesh size (2)",
            "TEST.IMS_PER_BATCH (3) must be divisible by the data-parallel mesh size (2)"]

    # rank 1 of 2 with no master listening: no one-process fallback
    code = ("import datetime\n"
            "from maskrcnn_tpu_torch.config import cfg\n"
            "from maskrcnn_tpu_torch.parallel import init_distributed\n"
            "c = cfg.clone(); c.MODEL.DEVICE = 'cpu'\n"
            "try:\n"
            "    init_distributed(c, timeout=datetime.timedelta(seconds=3))\n"
            "except RuntimeError as e:\n"
            "    print('RAISED', e)\n")
    env = _env(RANK="1", WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0 and proc.stdout.startswith(
        "RAISED could not make the process group of rank 1 of 2 at localhost:"), (
        proc.stdout + proc.stderr)[-3000:]

    # the tensor-parallel "model" axis is not ported; no group otherwise
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    c = flagship_cfg(tiny=True)
    c.MODEL.DEVICE = "cpu"
    assert init_distributed(c) == torch.device("cpu") and comm.get_world_size() == 1
    c.TPU.MESH_AXES, c.TPU.MESH_SHAPE = ("data", "model"), (-1, 2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 16"):
        init_distributed(c)
