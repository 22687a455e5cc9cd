"""Process-group communication: the host's collectives and the model's
global reductions.

Port of maskrcnn_tpu/utils/comm.py (after the reference
maskrcnn_benchmark/utils/comm.py:48-117) over ``torch.distributed``, one
process per card (parallel/distributed.py makes the default group, or the
caller does). Without a process group every function is the identity of one
process and runs no collective. In a group of one each collective runs and
returns its input unchanged.

The host's: ``synchronize`` (a barrier), ``all_gather`` of picklable data
(ragged sizes), ``reduce_dict`` (the mean or the sum of a dict of scalars).
The model's, on tensors of any device (gloo all-reduces CUDA tensors too):
``global_sum`` (the sum of a detached tensor over the data axis) and
``gather_rows`` (every data coordinate's equal-shaped tensor, stacked by
data rank). The host's collectives run on the CPU, through a gloo group
beside an NCCL one.

The process mesh (parallel/mesh.py, TPU.MESH_AXES / MESH_SHAPE) gives each
process a coordinate on the "data" axis and one on the "model" axis:
``data_rank``, ``data_size``, ``model_rank``, ``model_size``. Without a
mesh, or under a data-only one, the data axis is the world and the model
axis has one coordinate. The processes of one data coordinate (its model
group) hold the same images and the same replicated tensors, each with its
block of the sharded weights' output channels. A sharded layer gathers its
weight at use (models/layers.py:full_weight) through ``gather_from_model``:
the model group's blocks concatenated forward, this process's slice of the
gradient backward (every process of the group computes the whole weight's
gradient from the same batch, so the slice needs no collective).
"""

import os
import pickle

import torch
import torch.distributed as dist


def _initialized():
    return dist.is_available() and dist.is_initialized()


def get_rank():
    return dist.get_rank() if _initialized() else 0


def get_world_size():
    return dist.get_world_size() if _initialized() else 1


def get_local_rank():
    """This process's card among its host's: the launcher's LOCAL_RANK in a
    process group, else 0."""
    return int(os.environ.get("LOCAL_RANK", 0)) if _initialized() else 0


def is_main_process():
    return get_rank() == 0


_MESH = {}


def set_mesh(mesh):
    """Make `mesh` (parallel/mesh.py:ProcessMesh) the default group's."""
    _MESH.clear()
    _MESH[dist.group.WORLD] = mesh


def get_mesh():
    """The default group's process mesh; None without a group or a mesh."""
    return _MESH.get(dist.group.WORLD) if _initialized() else None


def data_rank():
    mesh = get_mesh()
    return get_rank() if mesh is None else mesh.data_rank


def data_size():
    mesh = get_mesh()
    return get_world_size() if mesh is None else mesh.data_size


def model_rank():
    mesh = get_mesh()
    return 0 if mesh is None else mesh.model_rank


def model_size():
    mesh = get_mesh()
    return 1 if mesh is None else mesh.model_size


def data_group():
    """The processes of this one's model coordinate (None: the world)."""
    mesh = get_mesh()
    return None if mesh is None else mesh.data_group


def model_group():
    """The processes of this one's data coordinate."""
    return get_mesh().model_group


_HOST_GROUPS = {}


def _host_group():
    """The group of the host's collectives: the default group under gloo;
    under NCCL a gloo group of the same processes (made at the first host
    collective, which every process reaches at the same point), so that
    they run on the CPU and do not wait for the card's queue."""
    if dist.get_backend() != "nccl":
        return None
    world = dist.group.WORLD
    if world not in _HOST_GROUPS:
        _HOST_GROUPS.clear()
        _HOST_GROUPS[world] = dist.new_group(backend="gloo")
    return _HOST_GROUPS[world]


def synchronize():
    """Barrier across the processes of the group."""
    if _initialized():
        dist.barrier(group=_host_group())


def all_gather(data):
    """Picklable `data` of every process, as a list by rank: the pickles,
    padded to the longest, gathered as bytes on the CPU."""
    if not _initialized():
        return [data]
    group = _host_group()
    buf = torch.frombuffer(bytearray(pickle.dumps(data)), dtype=torch.uint8)
    size = torch.tensor([buf.numel()], dtype=torch.int64)
    sizes = [torch.empty_like(size) for _ in range(get_world_size())]
    dist.all_gather(sizes, size, group=group)
    sizes = [int(s) for s in sizes]
    padded = torch.zeros(max(sizes), dtype=torch.uint8)
    padded[:buf.numel()] = buf
    out = [torch.empty_like(padded) for _ in sizes]
    dist.all_gather(out, padded, group=group)
    return [pickle.loads(t[:n].numpy().tobytes()) for t, n in zip(out, sizes)]


def reduce_dict(input_dict, average=True):
    """{key: the mean (or with average=False the sum) over the processes of
    float(value)}; the values as floats in one process."""
    local = {k: float(v) for k, v in input_dict.items()}
    if not _initialized():
        return local
    gathered = all_gather(local)
    out = {}
    for k in gathered[0]:
        total = sum(g[k] for g in gathered)
        out[k] = total / len(gathered) if average else total
    return out


def global_sum(t):
    """The sum of `t` over the data axis: an all-reduce of a detached copy
    (a count, say, that a loss divides by) over the data group, so that each
    data coordinate's share counts once. `t` itself without a group."""
    if not _initialized():
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=data_group())
    return out


def gather_rows(t):
    """[data_size, *t.shape]: every data coordinate's `t` (equal shapes),
    stacked by data rank; t[None] without a group. An all-reduce over the
    data group of a zero-filled buffer in which each process writes its own
    row (adding zeros is exact), which gloo runs on CUDA tensors as well
    (its all_gather does not)."""
    if not _initialized():
        return t[None]
    buf = t.new_zeros((data_size(),) + tuple(t.shape))
    buf[data_rank()] = t.detach()
    dist.all_reduce(buf, group=data_group())
    return buf


def model_block(t, dim):
    """This process's block of `t` along `dim` (model_size equal blocks)."""
    n = t.shape[dim] // model_size()
    return t.narrow(dim, model_rank() * n, n)


def gather_blocks(x, dim):
    """The model group's blocks of `x` concatenated along `dim`, by model
    rank; every process of the group gets the whole. An all-reduce of a
    zero-filled buffer in which each process writes its block, as
    ``gather_rows`` does, on every backend."""
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] = n * model_size()
    out = x.new_zeros(shape)
    out.narrow(dim, model_rank() * n, n).copy_(x)
    dist.all_reduce(out, group=model_group())
    return out


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim = dim
        return gather_blocks(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return model_block(grad, ctx.dim), None


def gather_from_model(x, dim):
    """The model group's blocks of `x` (a sharded weight) concatenated
    along `dim`; backward, this process's slice of the gradient (each
    process of the group holds the whole gradient already)."""
    return _GatherFromModel.apply(x, dim)
