"""The process mesh and the "model" axis's output-channel sharding.

Counterpart of maskrcnn_tpu/parallel/mesh.py. The JAX package lays its
devices out as a mesh of TPU.MESH_AXES ("data", and optionally "model")
of TPU.MESH_SHAPE (-1 fills the rest), jits one program over it, and with a
"model" axis above 1 shards the parameters and the optimizer state by
``tree_shardings``: every leaf of rank >= 2 whose last dim (the output
channels of an HWIO conv or an [in, out] fc) divides the axis is split on
it, the Megatron column layout; the rest is replicated. XLA then places the
collectives.

Here each process holds one card and one coordinate of the same mesh:
process r sits where ``np.arange(world).reshape(shape)`` puts r, the axes in
the order the config gives them. ``ProcessMesh`` makes the groups: the data
group (the processes of this one's model coordinate: the gradient
all-reduce, the model's batch-wide reductions) and the model group (those
of its data coordinate: the sharded weights' gathers), in the default
group's backend (the host's collectives stay on the world's gloo group,
utils/comm.py). ``sharded_dims`` is ``tree_shardings``'s rule read
in the port's layouts (utils/convert.py: OIHW convs and [out, in] fcs on
dim 0, the transposed convs' [in, out, kh, kw] on dim 1), ``shard_model``
cuts each sharded parameter and its momentum to this process's block (its
layer gathers the whole weight at use, models/layers.py:full_weight), and
``gather_state`` puts the full layout back for a checkpoint.
"""

import numpy as np
import torch
import torch.distributed as dist

from ..utils import comm

AXES = ("data", "model")


def mesh_shape(axes, shape, world):
    """{axis: size} of the config's axes and shape over `world` processes,
    -1 filled as create_mesh fills it; ValueError for an axis other than
    "data" or "model", or a shape that the processes do not fill."""
    axes, shape = tuple(axes), list(shape)
    if len(axes) != len(shape) or len(set(axes)) != len(axes) or set(axes) - set(AXES):
        raise ValueError("TPU.MESH_AXES {} / MESH_SHAPE {}: the axes are \"data\" and \"model\", "
                         "one size each".format(axes, tuple(shape)))
    fixed = int(np.prod([s for s in shape if s != -1]))
    filled = [world // fixed if s == -1 else s for s in shape]
    if int(np.prod(filled)) != world or min(filled) < 1:
        raise ValueError("TPU.MESH_AXES {} / MESH_SHAPE {} does not fit the {} process(es)".format(
            axes, tuple(shape), world))
    return dict(zip(axes, filled))


class ProcessMesh:
    """This process's coordinates and groups on a (data, model) mesh of the
    default group. Every process makes every subgroup, in the same order."""

    def __init__(self, axes, shape, rank, world):
        self.axes, self.shape = tuple(axes), tuple(shape)
        sizes = mesh_shape(axes, shape, world)
        self.data_size, self.model_size = sizes.get("data", 1), sizes.get("model", 1)
        grid = np.arange(world).reshape([sizes[a] for a in self.axes])
        order = [self.axes.index(a) for a in AXES if a in self.axes]
        grid = grid.transpose(order).reshape(self.data_size, self.model_size)
        (self.data_rank,), (self.model_rank,) = np.nonzero(grid == rank)
        self.data_rank, self.model_rank = int(self.data_rank), int(self.model_rank)
        self.model_ranks = [int(r) for r in grid[self.data_rank]]
        self.data_ranks = [int(r) for r in grid[:, self.model_rank]]
        self.data_group = self.model_group = None
        if self.model_size == 1:
            return
        for kind, members in (("model", grid), ("data", grid.T)):
            for ranks in members.tolist():
                group = dist.new_group(ranks)
                if rank in ranks:
                    setattr(self, kind + "_group", group)


def create_mesh(cfg):
    """The mesh of TPU.MESH_AXES / MESH_SHAPE over the default group (one
    process without one), made the group's mesh (utils/comm.py) unless the
    group has it already; returns it."""
    axes, shape = tuple(cfg.TPU.MESH_AXES), tuple(cfg.TPU.MESH_SHAPE)
    mesh = comm.get_mesh()
    if mesh is not None and (mesh.axes, mesh.shape) == (axes, shape):
        return mesh
    world = comm.get_world_size()
    if not dist.is_initialized():
        mesh_shape(axes, shape, world)  # ValueError as in a group
        return None
    mesh = ProcessMesh(axes, shape, comm.get_rank(), world)
    comm.set_mesh(mesh)
    return mesh


def sharded_dims(model, model_size):
    """{state-dict name: the dim it is sharded on over a model axis of
    `model_size`, or None (replicated)}: tree_shardings's rule in the
    port's layouts. A conv's or an fc's weight shards its output channels
    (dim 0; dim 1 of a transposed conv's [in, out, kh, kw]) when they
    divide the axis; biases, norms and frozen-BN buffers stay replicated."""
    dims = {name: None for name in model.state_dict()}
    if model_size == 1:
        return dims
    from ..models.layers import Conv2d, ConvTranspose2d, Linear

    for mod_name, module in model.named_modules():
        for leaf, p in module.named_parameters(recurse=False):
            name = mod_name + "." + leaf if mod_name else leaf
            if p.dim() < 2:
                continue
            if not isinstance(module, (Conv2d, ConvTranspose2d, Linear)):
                raise TypeError("{}: a parameter of rank {} outside a conv or an fc ({})".format(
                    name, p.dim(), type(module).__name__))
            dim = 1 if isinstance(module, ConvTranspose2d) else 0
            if p.shape[dim] % model_size == 0 and p.shape[dim] >= model_size:
                dims[name] = dim
    return dims


def shard_model(model, optimizer=None):
    """Cut every sharded parameter of `model` (sharded_dims at this
    process's model axis) to this process's block in place, so that the
    optimizer keeps its references, with its SGD momentum when it has one;
    each keeps its dim as ``model_dim``, by which its layer gathers it at
    use. Build, load and broadcast at the full layout first. Nothing on a
    model axis of 1. Returns {name: dim} of the sharded parameters."""
    m = comm.model_size()
    if m == 1:
        return {}
    dims = {k: d for k, d in sharded_dims(model, m).items() if d is not None}
    params = dict(model.named_parameters())
    state = optimizer.state if optimizer is not None else {}
    with torch.no_grad():
        for name, dim in dims.items():
            p = params[name]
            p.data = comm.model_block(p.data, dim).clone()
            p.grad = None
            p.model_dim = dim
            buf = state.get(p, {}).get("momentum_buffer")
            if buf is not None:
                state[p]["momentum_buffer"] = comm.model_block(buf, dim).clone()
    return dims


def _gathered(t, dim):
    return t if dim is None else comm.gather_blocks(t, dim)


def gather_state(model, optimizer=None):
    """(the model's state_dict, the optimizer's or None) at the full
    layout: each sharded parameter and its momentum gathered over the model
    group, which every process of the group calls together. The state
    itself without sharding."""
    model_state = model.state_dict()
    opt_state = None if optimizer is None else optimizer.state_dict()
    if comm.model_size() == 1:
        return model_state, opt_state
    with torch.no_grad():
        dims = {name: getattr(p, "model_dim", None) for name, p in model.named_parameters()}
        model_state = {k: _gathered(v, dims.get(k)) for k, v in model_state.items()}
        if optimizer is not None:
            params = [p for group in optimizer.param_groups for p in group["params"]]
            for idx, s in opt_state["state"].items():
                dim = getattr(params[idx], "model_dim", None)
                opt_state["state"][idx] = {k: _gathered(v, dim) if torch.is_tensor(v) and v.dim()
                                           else v for k, v in s.items()}
    return model_state, opt_state
