"""The training and evaluation steps.

PyTorch counterparts of maskrcnn_tpu/engine/train_step.py:
``make_train_step`` (forward through ``GeneralizedRCNN.train_forward``, the
sum of the losses, backward, the SGD step and the learning-rate schedule's
step) and ``make_eval_step`` (``infer_forward``).

In a process group the train step is the JAX mesh step (one program over
the global batch), one process a card: each process's losses are its data
coordinate's shares of the global batch's (the model divides by the global
counts and takes its rows of the global draws), the gradients are summed
over the data axis in one all-reduce before the optimizer steps
(``parallel.reduce_gradients``; summed, not averaged, since each share is
already divided by the global count), and the metrics are the global
losses. Every process then holds the same replicated parameters, bit for
bit, and the processes of a data group the same blocks of the sharded ones
(parallel/mesh.py).

Spans (utils/profiling.py:span, profiler ranges only while a profiler
records): "backward" around the backward pass (the ROIAlign and group
norm kernels' backwards open "roi_pool.bwd" and "group_norm.bwd" inside it,
on the autograd engine's thread),
"grad_reduce" around the gradients' reduction over the data axis, and
"optimizer", the JAX step's named scope, around the update.
"""

import torch

from ..parallel.distributed import reduce_gradients
from ..utils.profiling import span


def make_train_step(model, optimizer, scheduler, generator=None):
    """Returns step(batch, draws=None) -> metrics (the losses and their sum
    "loss", detached tensors on the model's device; reading one waits for
    the step; in a process group the global batch's).

    draws: the samplers' uniform draws of the global batch for this step
    (see train_forward); the ones not given are drawn from `generator`, by
    default a torch.Generator on the model's device seeded with 0."""
    if generator is None:
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(0)

    def step(batch, draws=None):
        losses = model.train_forward(batch, draws=draws, generator=generator)
        total = sum(losses.values())
        optimizer.zero_grad(set_to_none=True)
        with span("backward"):
            total.backward()
        with span("grad_reduce"):
            summed = reduce_gradients(model, list(losses.values()) + [total])
        with span("optimizer"):
            optimizer.step()
            scheduler.step()
        metrics = dict(zip(losses, summed))
        metrics["loss"] = summed[-1]
        return metrics

    return step


def make_eval_step(model):
    """Returns step(batch) -> the padded detection dict of
    ``model.infer_forward`` (on the model's device, not waited for), run
    under torch.inference_mode()."""

    def step(batch):
        with torch.inference_mode():
            return model.infer_forward(batch)

    return step
