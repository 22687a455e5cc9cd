"""Worker of the port's multi-process CPU tests (tests/test_torch_distributed.py).

Run as: python torch_distributed_worker.py <task> <rank> <world> <port> <dir>

One process of a gloo group on the CPU. It imports no JAX: the parent test
writes the job (<dir>/job.pt: the configuration as plain dicts, the
parameters, the batch, the draws) and compares what each rank writes to
<dir>/<task>_rank<rank>.pt. Tasks:
  comm      the collectives against their one-process identities
  step      one global-batch train step on this rank's rows of the job's
            batch, and the plain-DDP variant of its losses
  skip      do_train over batches without gt on one rank, then on both
  train_net python -m ...train_net's main from a torchrun-style
            environment: 2 iterations, then a resume to 4
  test_net  test_net's main in a group the worker made
  refuse    batches that the processes cannot share evenly
  mesh_step the global-batch step on a (data, model) mesh of the job's
            MESH_SHAPE: this data coordinate's rows, the sharded weights
  mesh_families  on a (data 1, model 2) mesh: the sharded
            primitives' outputs and gradients; each family of the job: the
            detections, one step, a checkpoint written under the mesh;
            then a one-process checkpoint resumed under it, one step more
  mesh_entry     train_net and test_net from a torchrun-style environment
            under a (data, model) mesh, and what the mesh refuses
Prints WORKER_OK <rank> on success.
"""

import datetime
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def init_group(rank, world, port):
    dist.init_process_group("gloo", init_method="tcp://localhost:{}".format(port), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))


class LogLines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def comm_task(rank, world, out):
    from maskrcnn_tpu_torch.utils import comm

    assert comm.get_rank() == rank and comm.get_world_size() == world
    gathered = comm.all_gather({"rank": rank, "blob": "x" * (10 + rank * 997)})
    assert [g["rank"] for g in gathered] == list(range(world))
    assert [len(g["blob"]) for g in gathered] == [10 + r * 997 for r in range(world)]
    mean = comm.reduce_dict({"loss": float(rank), "n": torch.tensor(2.0 * rank)})
    total = comm.reduce_dict({"loss": float(rank)}, average=False)
    comm.synchronize()
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (rank + 1) - 1e10 * (rank == 1)
    rows = comm.gather_rows(t)
    counts = comm.global_sum(torch.tensor(rank + 1))
    return {"mean": mean, "total": total, "rows": rows, "mine": t, "global_sum": counts,
            "int_rows": comm.gather_rows(torch.tensor([rank, -rank], dtype=torch.int64))}


def _model(job):
    from maskrcnn_tpu_torch.models.detector import GeneralizedRCNN

    model = GeneralizedRCNN(job["cfg"])
    model.load_state_dict(job["state"], strict=True)
    return model.eval()


def _rows(x, rank, b):
    return x[rank * b:(rank + 1) * b]


def step_task(rank, world, out, job):
    """The global-batch step on this rank's rows, recording the counts the
    model reduces; then, on fresh parameters, the losses a plain DDP port
    would compute here (every reduction local), and this rank's counts."""
    from maskrcnn_tpu_torch.engine import make_train_step
    from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer
    from maskrcnn_tpu_torch.utils import comm

    b = job["batch"]["images"].shape[0] // world
    batch = {k: _rows(torch.from_numpy(v), rank, b) for k, v in job["batch"].items()}
    draws = {k: torch.from_numpy(v) for k, v in job["draws"].items()}
    record = {"global_sum": [], "gather_rows": []}
    global_sum, gather_rows = comm.global_sum, comm.gather_rows

    def recording(name, fn):
        def wrapper(t):
            got = fn(t)
            record[name].append((t.detach().clone(), got.detach().clone()))
            return got
        return wrapper

    comm.global_sum = recording("global_sum", global_sum)
    comm.gather_rows = recording("gather_rows", gather_rows)
    try:
        model = _model(job)
        opt = make_optimizer(job["cfg"], model)
        sched = make_lr_scheduler(job["cfg"], opt)
        metrics = make_train_step(model, opt, sched)(batch, draws=draws)
    finally:
        comm.global_sum, comm.gather_rows = global_sum, gather_rows
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}

    # a plain DDP port: the k-th score, the denominators and the mask cap
    # of this rank alone, the losses averaged over the ranks
    ddp = _model(job)
    comm.global_sum, comm.gather_rows = (lambda t: t), (lambda t: t[None])
    get_world_size = comm.get_world_size
    comm.get_world_size = lambda: 1
    try:
        with torch.no_grad():
            local = ddp.train_forward(batch, draws=draws)
    finally:
        comm.global_sum, comm.gather_rows = global_sum, gather_rows
        comm.get_world_size = get_world_size
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "ddp_losses": comm.reduce_dict(local), "grads": grads,
            "params": {k: v.clone() for k, v in model.state_dict().items()},
            "record": record}


class _Batches:
    """do_train's loader: len() is the last iteration."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def skip_task(rank, world, out, job):
    """Three iterations: this rank's rows of the batch; the same with rank
    1's gt removed; every rank's gt removed. Returns the iterations each
    rank stepped."""
    import types

    from maskrcnn_tpu_torch.engine.trainer import do_train
    from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer

    b = job["batch"]["images"].shape[0] // world
    full = {k: _rows(torch.from_numpy(v), rank, b) for k, v in job["batch"].items()}
    empty = dict(full, gt_labels=torch.zeros_like(full["gt_labels"]))
    batches = [full, empty if rank == 1 else full, empty]
    model = _model(job)
    stepped = []
    forward = model.train_forward

    def counting(batch, **kwargs):
        stepped.append(len(stepped))
        return forward(batch, **kwargs)

    model.train_forward = counting
    opt = make_optimizer(job["cfg"], model)
    sched = make_lr_scheduler(job["cfg"], opt)
    arguments = {"iteration": 0}
    saver = types.SimpleNamespace(save=lambda name, **kw: None)
    logs = LogLines()
    logging.getLogger("maskrcnn_tpu_torch.trainer").addHandler(logs)
    do_train(model, opt, sched, _Batches(batches), saver, torch.device("cpu"), 100, arguments)
    skipped = [int(line.split("=")[1].split()[0]) for line in logs.lines if "skipped" in line]
    return {"steps": len(stepped), "skipped": skipped, "iteration": arguments["iteration"],
            "params": {k: v.clone() for k, v in model.state_dict().items()}}


def train_net_task(rank, world, out, job):
    """train_net from a torchrun-style environment (its init_distributed
    makes the gloo group): 2 iterations with a checkpoint at 2, then a
    resume to 4 that loads model_final on both ranks."""
    from maskrcnn_tpu_torch.tools import train_net

    logs = LogLines()
    for name in ("maskrcnn_tpu_torch", "maskrcnn_tpu_torch.checkpointer"):
        logging.getLogger(name).addHandler(logs)
    _, meters = train_net.main(job["args"] + ["SOLVER.MAX_ITER", "2"])
    first = list(logs.lines)
    logs.lines.clear()
    model, meters2 = train_net.main(job["args"] + ["SOLVER.MAX_ITER", "4"])
    return {"first": first, "second": list(logs.lines), "world": dist.get_world_size(),
            "backend": dist.get_backend(),
            "params": {k: v.clone() for k, v in model.state_dict().items()},
            "losses": {k: m.global_avg for k, m in meters2.meters.items() if k.startswith("loss")}}


def test_net_task(rank, world, out, job):
    from maskrcnn_tpu_torch.tools import test_net

    results = test_net.main(job["args"])
    return {"results": None if results is None else
            [{k: dict(v) for k, v in r[0].results.items()} for r in results]}


def refuse_task(rank, world, out, job):
    from maskrcnn_tpu_torch.tools import test_net, train_net

    caught = []
    for main, args, key in ((train_net.main, job["train_args"], "SOLVER.IMS_PER_BATCH"),
                            (test_net.main, job["test_args"], "TEST.IMS_PER_BATCH")):
        try:
            main(args + [key, "3"])
        except ValueError as e:
            caught.append(str(e))
    return {"caught": caught}


def _mesh(cfg, axes=("data", "model"), shape=(-1, 2)):
    from maskrcnn_tpu_torch.parallel import init_distributed

    cfg.TPU.MESH_AXES, cfg.TPU.MESH_SHAPE = axes, shape
    cfg.MODEL.DEVICE = "cpu"
    init_distributed(cfg)
    return cfg


def _gathered_step(model, opt, sched, batch, draws):
    """One step of the sharded `model`; (metrics, the gradients and the
    parameters at the full layout, this process's own parameters)."""
    from maskrcnn_tpu_torch.engine import make_train_step
    from maskrcnn_tpu_torch.parallel import gather_state
    from maskrcnn_tpu_torch.utils import comm

    metrics = make_train_step(model, opt, sched)(batch, draws=draws)
    grads = {n: comm.gather_blocks(p.grad, p.model_dim) if hasattr(p, "model_dim")
             else p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    state, opt_state = gather_state(model, opt)
    local = {n: p.detach().clone() for n, p in model.named_parameters()}
    return ({k: v.item() for k, v in metrics.items()}, grads,
            {k: v.clone() for k, v in state.items()}, opt_state, local)


def mesh_step_task(rank, world, out, job):
    from maskrcnn_tpu_torch.parallel import shard_model
    from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer
    from maskrcnn_tpu_torch.utils import comm

    cfg = _mesh(job["cfg"], shape=job["shape"])
    b = job["batch"]["images"].shape[0] // comm.data_size()
    batch = {k: _rows(torch.from_numpy(v), comm.data_rank(), b) for k, v in job["batch"].items()}
    draws = {k: torch.from_numpy(v) for k, v in job["draws"].items()}
    model = _model(job)
    opt = make_optimizer(cfg, model)
    sched = make_lr_scheduler(cfg, opt)
    dims = shard_model(model, opt)
    metrics, grads, params, _, local = _gathered_step(model, opt, sched, batch, draws)
    return {"metrics": metrics, "grads": grads, "params": params, "local": local, "dims": dims,
            "coords": (comm.data_rank(), comm.model_rank())}


# the sharded primitives at a model axis of 2: (module, its arguments);
# "frozen_bn" is conv_frozen_bn over a 1x1 conv and a frozen BN of 8
PRIMITIVES = {
    "conv": ("Conv2d", dict(in_channels=6, out_channels=8, kernel_size=3, padding=1)),
    "grouped": ("Conv2d", dict(in_channels=8, out_channels=8, kernel_size=3, padding=1,
                               groups=4, bias=False)),
    "grouped_3": ("Conv2d", dict(in_channels=6, out_channels=6, kernel_size=3, padding=1,
                                 groups=3)),
    "depthwise": ("Conv2d", dict(in_channels=8, out_channels=8, kernel_size=3, stride=2,
                                 padding=1, groups=8, bias=False)),
    "transposed": ("ConvTranspose2d", dict(in_channels=6, out_channels=8, kernel_size=2,
                                           stride=2)),
    "fc": ("Linear", dict(in_features=12, out_features=8)),
    "frozen_bn": ("Conv2d", dict(in_channels=6, out_channels=8, kernel_size=1, bias=False)),
}


def primitive(name, seed=0):
    """(the module of PRIMITIVES[name] in a container, its seeded input,
    the weights of the scalar its output is reduced to)."""
    import torch.nn as nn

    from maskrcnn_tpu_torch.models import layers

    kind, kwargs = PRIMITIVES[name]
    gen = torch.Generator().manual_seed(seed)
    box = nn.Module()
    box.m = getattr(layers, kind)(**kwargs)
    if name == "frozen_bn":
        box.bn = layers.FrozenBatchNorm2d(8)
    with torch.no_grad():
        for t in box.state_dict().values():
            t.copy_(torch.rand(t.shape, generator=gen) + 0.5 if t.dim() == 1 else
                    torch.randn(t.shape, generator=gen))
    if kind == "Linear":
        x = torch.randn(5, 12, generator=gen)
    else:
        x = torch.randn(2, kwargs["in_channels"], 6, 7, generator=gen).contiguous(
            memory_format=torch.channels_last)
    with torch.no_grad():
        y = run_primitive(name, box, x)
    return box, x, torch.randn(y.shape, generator=gen)


def run_primitive(name, box, x):
    from maskrcnn_tpu_torch.models import layers

    return layers.conv_frozen_bn(x, box.m, box.bn) if name == "frozen_bn" else box.m(x)


def primitive_grads(name, box, x, w):
    """The primitive's output, and the gradients of sum(output * w) with
    respect to its input and (gathered to the full layout) its weights."""
    from maskrcnn_tpu_torch.utils import comm

    x = x.clone().requires_grad_(True)
    y = run_primitive(name, box, x)
    (y * w).sum().backward()
    grads = {n: comm.gather_blocks(p.grad, p.model_dim) if hasattr(p, "model_dim")
             else p.grad for n, p in box.named_parameters()}
    return {"out": y.detach(), "x": x.grad, **grads}


def mesh_families_task(rank, world, out, job):
    from maskrcnn_tpu_torch.config.cfgnode import CfgNode
    from maskrcnn_tpu_torch.parallel import shard_model
    from maskrcnn_tpu_torch.solver import make_lr_scheduler, make_optimizer
    from maskrcnn_tpu_torch.utils.checkpoint import Checkpointer

    from maskrcnn_tpu_torch.config import cfg as defaults

    _mesh(defaults.clone())
    results = {"primitives": {}}
    for name in PRIMITIVES:
        box, x, w = primitive(name)
        dims = shard_model(box)
        results["primitives"][name] = dict(primitive_grads(name, box, x, w), dims=dims)
    for fam in job["families"]:
        cfg = _mesh(CfgNode(fam["cfg"]))
        model = _model(dict(fam, cfg=cfg))
        opt = make_optimizer(cfg, model)
        sched = make_lr_scheduler(cfg, opt)
        dims = shard_model(model, opt)
        with torch.no_grad():
            det = model.infer_forward({k: torch.from_numpy(v) for k, v in fam["infer"].items()})
        batch = {k: torch.from_numpy(v) for k, v in fam["batch"].items()}
        draws = {k: torch.from_numpy(v) for k, v in fam["draws"].items()}
        metrics, grads, params, _, _ = _gathered_step(model, opt, sched, batch, draws)
        Checkpointer(model, opt, sched, os.path.join(out, fam["name"])).save(
            "model_0000001", iteration=1)
        results[fam["name"]] = {"det": det, "metrics": metrics, "grads": grads,
                                "params": params, "dims": dims}
    # a checkpoint of one process (after one step: momentum) resumed here
    res = job["resume"]
    cfg = _mesh(CfgNode(res["cfg"]))
    model = _model(dict(res, cfg=cfg))
    opt = make_optimizer(cfg, model)
    sched = make_lr_scheduler(cfg, opt)
    extra = Checkpointer(model, opt, sched).load(res["file"])
    shard_model(model, opt)
    batch = {k: torch.from_numpy(v) for k, v in res["batch"].items()}
    draws = {k: torch.from_numpy(v) for k, v in res["draws"].items()}
    metrics, _, params, opt_state, _ = _gathered_step(model, opt, sched, batch, draws)
    results["resumed"] = {"extra": extra, "metrics": metrics, "params": params,
                          "optimizer": opt_state}
    return results


def mesh_entry_task(rank, world, out, job):
    """train_net under ("data", "model") / (-1, 2): 2 iterations, then a
    resume to 4 that validates and tests; test_net under ("model", "data")
    / (2, -1); what the mesh refuses."""
    from maskrcnn_tpu_torch.parallel import gather_state
    from maskrcnn_tpu_torch.tools import test_net, train_net
    from maskrcnn_tpu_torch.utils import comm

    logs = LogLines()
    for name in ("maskrcnn_tpu_torch", "maskrcnn_tpu_torch.checkpointer",
                 "maskrcnn_tpu_torch.inference"):
        logging.getLogger(name).addHandler(logs)
    gathered = []
    all_gather = comm.all_gather

    def recording(data):
        got = all_gather(data)
        if isinstance(data, dict) and all(isinstance(k, int) for k in data):
            gathered.append([sorted(d) for d in got])  # inference's shards by rank
        return got

    comm.all_gather = recording
    mesh = ["TPU.MESH_AXES", "('data', 'model')", "TPU.MESH_SHAPE", "(-1, 2)"]
    try:
        train_net.main(["--skip-test"] + job["train_args"] + mesh + ["SOLVER.MAX_ITER", "2"])
        first = list(logs.lines)
        logs.lines.clear()
        model, meters = train_net.main(job["train_args"] + mesh + [
            "SOLVER.MAX_ITER", "4", "SOLVER.TEST_PERIOD", "4"])
        second = list(logs.lines)
        coords = (comm.data_rank(), comm.model_rank())
        state, _ = gather_state(model)
        train_gathered = list(gathered)
        gathered.clear()
        results = test_net.main(job["test_args"] + [
            "TPU.MESH_AXES", "('model', 'data')", "TPU.MESH_SHAPE", "(2, -1)"])
        test_coords = (comm.data_rank(), comm.model_rank())
    finally:
        comm.all_gather = all_gather
    caught = []
    for opts in (["SOLVER.IMS_PER_BATCH", "3"], ["TPU.MESH_SHAPE", "(3, -1)"],
                 ["TPU.MESH_AXES", "('data', 'pipe')"]):
        try:
            train_net.main(["--skip-test"] + job["train_args"] + mesh + opts)
        except ValueError as e:
            caught.append(str(e))
    return {"first": first, "second": second, "coords": coords, "test_coords": test_coords,
            "state": {k: v.clone() for k, v in state.items()},
            "losses": {k: m.global_avg for k, m in meters.meters.items() if k.startswith("loss")},
            "train_gathered": train_gathered, "test_gathered": gathered,
            "results": None if results is None else
            [{k: dict(v) for k, v in r[0].results.items()} for r in results],
            "caught": caught}


def main():
    task, rank, world, port, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        sys.argv[4], sys.argv[5]
    torch.set_num_threads(2)
    job_file = os.path.join(out, "job.pt")
    job = torch.load(job_file, weights_only=False) if os.path.exists(job_file) else {}
    if "cfg" in job:
        from maskrcnn_tpu_torch.config.cfgnode import CfgNode

        job["cfg"] = CfgNode(job["cfg"])
    if task not in ("train_net", "mesh_entry"):
        init_group(rank, world, port)
    fn = {"comm": comm_task, "step": step_task, "skip": skip_task, "train_net": train_net_task,
          "test_net": test_net_task, "refuse": refuse_task, "mesh_step": mesh_step_task,
          "mesh_families": mesh_families_task, "mesh_entry": mesh_entry_task}[task]
    result = fn(rank, world, out, job) if task != "comm" else fn(rank, world, out)
    torch.save(result, os.path.join(out, "{}_rank{}.pt".format(task, rank)))
    dist.destroy_process_group()
    print("WORKER_OK {}".format(rank), flush=True)


if __name__ == "__main__":
    main()
