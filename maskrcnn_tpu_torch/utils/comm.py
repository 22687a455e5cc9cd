"""Process-group bookkeeping for the host code.

Port of maskrcnn_tpu/utils/comm.py for one process: the rank of an
initialized ``torch.distributed`` group, else 0. Gathers and
reductions across processes wait for multi-card training (ROADMAP.md
Queue 1 item 3).
"""

import torch.distributed as dist


def get_rank():
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main_process():
    return get_rank() == 0
