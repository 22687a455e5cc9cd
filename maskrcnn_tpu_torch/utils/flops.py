"""Achieved FLOP/s and MFU of a step.

PyTorch counterpart of maskrcnn_tpu/utils/flops.py, which reads XLA's cost
analysis of the compiled program. Here the count comes from
``torch.utils.flop_counter.FlopCounterMode`` over one call: the FLOPs of
the convolutions, matrix products and attention it knows, forward and
backward, at the shapes of that call. It leaves out elementwise work,
reductions, sorts, and the port's hand-written CUDA kernels (NMS, ROIAlign
and its backwards, the anchor matcher), which launch outside PyTorch's
operators: an MFU from it is the dense work's share of the card's peak.
XLA's count of a Pallas custom call is not comparable either, so the two
packages' FLOPs a step differ by design.
"""

import torch

# Dense (no sparsity) bfloat16 tensor-core peak, TFLOP/s, by a part of
# torch.cuda.get_device_name(): NVIDIA's data sheets (H100 Tensor Core GPU:
# SXM 989, PCIe 756, NVL 835; H200: 989; A100 Tensor Core GPU: 312), each
# at the part's full power limit. The first entry found in the name wins.
_PEAK_BF16_TFLOPS = (
    ("H100 PCIe", 756.0),
    ("H100 NVL", 835.0),
    ("H100", 989.0),
    ("H200", 989.0),
    ("A100", 312.0),
)


def device_peak_tflops(name=None):
    """The dense bf16 peak of the card called `name` (by default the
    current CUDA device's name), or None for an unknown card or no card."""
    if name is None:
        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name()
    return next((peak for part, peak in _PEAK_BF16_TFLOPS if part in name), None)


def step_flops(fn, *args, **kwargs):
    """The FLOPs FlopCounterMode counts in one call fn(*args, **kwargs)
    (see the module's docstring for what it leaves out)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()


def mfu_fields(flops, seconds_per_step, name=None):
    """{"tflops_per_sec": achieved TFLOP/s, "mfu": its share of the card's
    peak (device_peak_tflops(name))}; "mfu" is left out for an unknown
    card, and both for an unknown count or time."""
    if not flops or not seconds_per_step:
        return {}
    achieved = flops / seconds_per_step / 1e12
    out = {"tflops_per_sec": achieved}
    peak = device_peak_tflops(name)
    if peak:
        out["mfu"] = achieved / peak
    return out
