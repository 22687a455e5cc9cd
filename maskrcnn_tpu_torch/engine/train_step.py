"""The single-device training and evaluation steps.

PyTorch counterparts of maskrcnn_tpu/engine/train_step.py without a mesh:
``make_train_step`` (forward through ``GeneralizedRCNN.train_forward``, the
sum of the losses, backward, the SGD step and the learning-rate schedule's
step) and ``make_eval_step`` (``infer_forward``).
"""

import torch


def make_train_step(model, optimizer, scheduler, generator=None):
    """Returns step(batch, draws=None) -> metrics (the losses and their sum
    "loss", detached tensors on the model's device; reading one waits for
    the step).

    draws: the samplers' uniform draws for this step (see train_forward);
    the ones not given are drawn from `generator`, by default a
    torch.Generator on the model's device seeded with 0."""
    if generator is None:
        device = next(model.parameters()).device
        generator = torch.Generator(device=device).manual_seed(0)

    def step(batch, draws=None):
        losses = model.train_forward(batch, draws=draws, generator=generator)
        total = sum(losses.values())
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        scheduler.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss"] = total.detach()
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
