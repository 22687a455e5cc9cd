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


def main():
    task, rank, world, port, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        sys.argv[4], sys.argv[5]
    torch.set_num_threads(2)
    job_file = os.path.join(out, "job.pt")
    job = torch.load(job_file, weights_only=False) if os.path.exists(job_file) else {}
    if "cfg" in job:
        from maskrcnn_tpu_torch.config.cfgnode import CfgNode

        job["cfg"] = CfgNode(job["cfg"])
    if task != "train_net":
        init_group(rank, world, port)
    fn = {"comm": comm_task, "step": step_task, "skip": skip_task, "train_net": train_net_task,
          "test_net": test_net_task, "refuse": refuse_task}[task]
    result = fn(rank, world, out, job) if task != "comm" else fn(rank, world, out)
    torch.save(result, os.path.join(out, "{}_rank{}.pt".format(task, rank)))
    dist.destroy_process_group()
    print("WORKER_OK {}".format(rank), flush=True)


if __name__ == "__main__":
    main()
