"""Process-group bookkeeping for the host code.

Port of maskrcnn_tpu/utils/comm.py for one process: the rank and world
size of an initialized ``torch.distributed`` group, else 0 and 1; the
barrier and the gather of evaluation results are those of one process
(``synchronize`` does nothing, ``all_gather`` returns ``[data]``). Several
processes wait for multi-card training (ROADMAP.md Queue 1 item 3), and
until then these raise rather than gather one rank's share.
"""

import torch.distributed as dist


def _initialized():
    return dist.is_available() and dist.is_initialized()


def get_rank():
    return dist.get_rank() if _initialized() else 0


def get_world_size():
    return dist.get_world_size() if _initialized() else 1


def is_main_process():
    return get_rank() == 0


def _single_process(what):
    if get_world_size() > 1:
        raise NotImplementedError("comm.{} across {} processes waits for multi-card training "
                                  "(ROADMAP.md Queue 1 item 3)".format(what, get_world_size()))


def synchronize():
    """Barrier across processes: nothing to wait for in one process."""
    _single_process("synchronize")


def all_gather(data):
    """Picklable `data` of every process, as a list by rank."""
    _single_process("all_gather")
    return [data]
