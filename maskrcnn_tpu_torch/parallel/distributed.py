"""Data and tensor parallelism with one process per card under
``torch.distributed``.

The counterpart of maskrcnn_tpu/parallel/mesh.py's use in the JAX step. The
JAX package jits one program over a device mesh: the batch sharded on the
"data" axis and replicated on the "model" axis, the parameters replicated
or (with a "model" axis above 1) sharded on their output channels, and
sharding propagation keeping every reduction global, so the step on N
devices computes what one device computes on the whole global batch. Here
each process holds one card, one coordinate of the same mesh
(parallel/mesh.py) and its data coordinate's share of that batch, and the
step keeps the same semantics explicitly:

* the model's batch-wide reductions run over the data axis
  (``utils/comm.py``: ``global_sum`` of the loss denominators,
  ``gather_rows`` of the scores of the batch-wide FPN top-k and of the
  mask head's positive counts), so each process's loss is its data
  coordinate's share of the global loss;
* the sharded layers gather their weights over the model axis at use
  (models/layers.py:full_weight), so every process of a model group
  computes the same activations and losses as one process would;
* ``reduce_gradients`` sums the gradients (not their mean) over the data
  axis in one all-reduce of a flat buffer, with the loss shares, before
  the optimizer steps; under a model axis the replicated leaves then take
  model coordinate 0's values (one broadcast over the model group), so
  that they stay equal bit for bit whatever the card's backward rounds;
  every process then holds the global gradient of its blocks and the same
  replicated parameters;
* ``broadcast_parameters`` gives every process rank 0's parameters after
  loading, as DDP does at construction, at the full layout (shard after).

``init_distributed(cfg)`` makes the default group from the launcher's
environment (``torchrun``: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT): NCCL on the card, gloo on the CPU. A group the caller made
first is kept. Without WORLD_SIZE in the environment it makes no group.
Either way it lays out the mesh of TPU.MESH_AXES / MESH_SHAPE over the
processes (ValueError for a mesh they do not fill).
"""

import itertools
import os

import torch
import torch.distributed as dist

from ..utils import comm
from ..utils.miscellaneous import cfg_device
from .mesh import create_mesh


def init_distributed(cfg, timeout=None):
    """The default process group and this process's device.

    With a group already made (by the caller), keep it. Else, with
    WORLD_SIZE in the environment, make it from the launcher's variables:
    NCCL when MODEL.DEVICE is CUDA, gloo on the CPU; if it cannot be made,
    raise (never carry on as one process). Without WORLD_SIZE, make no
    group. Then lay out the process mesh (parallel/mesh.py:create_mesh;
    ValueError when TPU.MESH_SHAPE does not fit the processes or an axis is
    neither "data" nor "model"). `timeout`: the group's (torch's default
    when None).

    Returns the torch.device of this process: MODEL.DEVICE, where "cuda"
    without an index means cuda:LOCAL_RANK in a group (made current)."""
    device = cfg_device(cfg)
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ.get("RANK", 0))
        kwargs = {} if timeout is None else {"timeout": timeout}
        try:
            dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                    init_method="env://", world_size=world, rank=rank, **kwargs)
        except Exception as e:
            raise RuntimeError(
                "could not make the process group of rank {} of {} at {}:{}: {}".format(
                    rank, world, os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT"),
                    e)) from e
    if device.type == "cuda" and dist.is_initialized():
        if device.index is None:
            device = torch.device("cuda", comm.get_local_rank())
        torch.cuda.set_device(device)
    create_mesh(cfg)
    return device


def images_per_process(images_per_batch, key):
    """The images each process takes of a global batch of
    `images_per_batch` (the config key `key`): its data coordinate's share;
    raises ValueError when the data coordinates cannot share it evenly."""
    world = comm.data_size()
    if images_per_batch % world != 0:
        raise ValueError("{} ({}) must be divisible by the data-parallel mesh size ({})".format(
            key, images_per_batch, world))
    return images_per_batch // world


def broadcast_parameters(model, src=0):
    """Every process takes process `src`'s parameters and buffers: one
    broadcast a dtype of the tensors flattened. Nothing without a group."""
    if not dist.is_initialized():
        return
    by_dtype = {}
    for t in itertools.chain(model.parameters(), model.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src)
            for t, v in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(v.view_as(t))


def reduce_gradients(model, extra=()):
    """Sum the gradient of every parameter of `model` that has one over the
    data axis, in place, with the 0-dim tensors `extra` (the loss shares)
    in the same all-reduce of one flat float32 buffer. Under a model axis
    the replicated leaves' gradients and `extra` (the buffer's head) are
    then model coordinate 0's, broadcast over the model group; the
    sharded blocks' (its tail) are this process's own. Returns the summed
    `extra`; without a group `extra` detached and no collective."""
    extra = [e.detach() for e in extra]
    if not dist.is_initialized():
        return extra
    with_grad = [p for p in model.parameters() if p.grad is not None]
    sharded = [p for p in with_grad if hasattr(p, "model_dim")]
    grads = [p.grad for p in with_grad if not hasattr(p, "model_dim")]
    head = sum(g.numel() for g in grads) + len(extra)
    grads += [p.grad for p in sharded]
    flat = torch.cat([e.reshape(-1).float() for e in extra]
                     + [g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=comm.data_group())
    if comm.model_size() > 1:
        dist.broadcast(flat[:head], comm.get_mesh().model_ranks[0], group=comm.model_group())
    parts = flat.split([1] * len(extra) + [g.numel() for g in grads])
    for g, v in zip(grads, parts[len(extra):]):
        g.copy_(v.view_as(g))
    return [v.reshape(()).to(e.dtype) for e, v in zip(extra, parts)]
