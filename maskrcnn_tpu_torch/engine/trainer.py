"""Training loop.

Port of maskrcnn_tpu/engine/trainer.py (after the reference
maskrcnn_benchmark/engine/trainer.py): batches from the loader through
``make_train_step``, batches without ground truth skipped, a log line every
20 iterations and at the last (eta, losses, time and data-wait meters,
learning rate), a warning on a non-finite loss, a checkpoint every
``checkpoint_period`` iterations, validation (the caller's
``run_validation(model, iteration)``) every ``test_period`` iterations, and
``model_final`` at the end. The time meters leave validation out.

Each batch is copied to the device with ``non_blocking=True`` (the loader
pins it on CUDA). The losses are read back only on logging iterations, so
the other steps queue on the card without a wait; the time meter of a step
is then its host time, and the log line's read brings it up to date. The
samplers' draws come from the step's own generator (``draws=None``), seeded
before each step from the iteration (``step_seed``) as the JAX trainer folds
the iteration into its key: a run resumed at iteration k draws from k + 1
on what a straight run draws there.

In a process group (one process a card, each loading its data
coordinate's share of the global batch) the step is the global-batch step
(train_step.py), so the trainer's decisions are global too: a batch is
skipped only when no process's share holds ground truth (one process
skipping alone would desync the step's collectives), the logged losses are
reduced over the processes (``comm.reduce_dict``), checkpoints are written
by rank 0 (gathered over its model group first, utils/checkpoint.py) and
followed by a barrier, so that a resume on any rank reads a whole file.
Under a "model" axis the processes of a model group must hold the same
batch (data/build.py seeds their loaders alike): the gather that decides
the skip carries a fingerprint of each batch, and differing ones within a
model group raise.

Device trace (as the JAX trainer's jax.profiler hook): with
MASKRCNN_TPU_PROFILE_DIR set, a torch.profiler trace (the host, and the
card's kernels on a CUDA device) starts before iteration
MASKRCNN_TPU_PROFILE_AT (default 50) and stops after iteration AT + 5, once
that step's loss is ready (a synchronize, as JAX's block_until_ready); each
process writes it as a Chrome trace, DIR/rank<rank>.pt.trace.json, and logs
the path. Each step runs in a span "iteration <n>" (utils/profiling.py:span,
a record_function range while the profiler records), the model's and the
step's spans inside it (utils/profiling.py PHASES and PORT_SPANS: the
JAX scopes, and the port's anchors, proposal parts, roi_pool, backward,
grad_reduce and the "<stage>.wait" spans around host waits). A skipped
iteration AT starts no trace, as in JAX; where AT + 5 is skipped the trace
stops after the next step run, or when the loop ends. Unset, no profiler
starts.
"""

import datetime
import logging
import math
import os
import time

import torch
from torch.profiler import profile

from ..utils import comm
from ..utils.metric_logger import MetricLogger
from ..utils.profiling import activities, span, synchronize
from .train_step import make_train_step


DRAW_SEED = 0  # the JAX trainer's PRNGKey(0)


def step_seed(iteration):
    """The draw generator's seed at `iteration`: a function of (DRAW_SEED,
    iteration), the counterpart of jax.random.fold_in(PRNGKey(0), iteration)."""
    return (DRAW_SEED << 32) | iteration


def _fingerprint(batch):
    return (tuple(batch["images"].shape), float(batch["gt_boxes"].double().sum()),
            int(batch["image_sizes"].sum()))


def _global_has_gt(batch):
    """Whether each process's batch holds ground truth, by rank; raises if
    two processes of one model group hold different batches."""
    has_gt = bool((batch["gt_labels"] > 0).any())
    mesh = comm.get_mesh()
    if mesh is None or mesh.model_size == 1:
        return comm.all_gather(has_gt)
    got = comm.all_gather((has_gt, _fingerprint(batch)))
    prints = {got[r][1] for r in mesh.model_ranks}
    if len(prints) > 1:
        raise RuntimeError("the model group {} holds different batches: {}".format(
            mesh.model_ranks, sorted(prints)))
    return [g[0] for g in got]


def do_train(model, optimizer, scheduler, data_loader, checkpointer, device, checkpoint_period,
             arguments, test_period=0, run_validation=None):
    """Train for the loader's iterations after arguments["iteration"]
    (updated as it goes), calling run_validation(model, iteration) after
    every test_period-th iteration when both are given. Returns the
    MetricLogger: per-iteration "time" and "data" (seconds waiting for the
    loader), and the losses of the logged iterations."""
    logger = logging.getLogger("maskrcnn_tpu_torch.trainer")
    logger.info("Start training")
    meters = MetricLogger(delimiter="  ")
    max_iter = len(data_loader)
    start_iter = arguments["iteration"]
    generator = torch.Generator(device=device)
    step = make_train_step(model, optimizer, scheduler, generator=generator)
    profile_dir = os.environ.get("MASKRCNN_TPU_PROFILE_DIR")
    profile_at = int(os.environ.get("MASKRCNN_TPU_PROFILE_AT", "50"))
    prof = None

    start_training_time = time.time()
    end = time.time()
    iteration = start_iter
    for batch in data_loader:
        data_time = time.time() - end
        iteration += 1
        arguments["iteration"] = iteration
        if not any(_global_has_gt(batch)):
            logger.warning("Iteration={} || batch has no ground truth, skipped".format(iteration))
            end = time.time()
            continue

        generator.manual_seed(step_seed(iteration))
        device_batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()
                        if k != "indices"}
        if profile_dir and iteration == profile_at:
            prof = profile(activities=activities(device))
            prof.start()
        with span("iteration {}".format(iteration)):
            metrics = step(device_batch)
        if prof is not None and iteration >= profile_at + 5:
            _write_trace(prof, profile_dir, device, logger)
            prof = None
        logged = iteration % 20 == 0 or iteration == max_iter
        losses = comm.reduce_dict(metrics) if logged else {}
        batch_time = time.time() - end
        end = time.time()
        meters.update(time=batch_time, data=data_time, **losses)
        if logged:
            if not all(math.isfinite(v) for v in losses.values()):
                logger.warning("non-finite loss at iter {}: {}: training has diverged".format(
                    iteration, losses))
            eta_seconds = meters.meters["time"].global_avg * (max_iter - iteration)
            logger.info(meters.delimiter.join([
                "eta: {eta}", "iter: {iter}", "{meters}", "lr: {lr:.6f}",
                "max mem: {memory:.0f}",
            ]).format(
                eta=str(datetime.timedelta(seconds=int(eta_seconds))), iter=iteration,
                meters=str(meters), lr=optimizer.param_groups[0]["lr"],
                memory=(torch.cuda.max_memory_allocated() / 1024 / 1024
                        if device.type == "cuda" else 0.0),
            ))
        if iteration % checkpoint_period == 0:
            checkpointer.save("model_{:07d}".format(iteration), **arguments)
            comm.synchronize()
        if test_period > 0 and run_validation and iteration % test_period == 0:
            logger.info("Validation at iteration {}".format(iteration))
            run_validation(model, iteration)
            end = time.time()
        if iteration >= max_iter:
            break
    if prof is not None:
        _write_trace(prof, profile_dir, device, logger)

    checkpointer.save("model_final", **arguments)
    comm.synchronize()
    total_training_time = time.time() - start_training_time
    logger.info("Total training time: {} ({:.4f} s / it)".format(
        str(datetime.timedelta(seconds=int(total_training_time))),
        total_training_time / max(max_iter - start_iter, 1)))
    return meters


def _write_trace(prof, profile_dir, device, logger):
    """Stop the trace once the device has finished the traced steps and
    write this process's Chrome trace."""
    synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "rank{}.pt.trace.json".format(comm.get_rank()))
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to {}".format(path))
