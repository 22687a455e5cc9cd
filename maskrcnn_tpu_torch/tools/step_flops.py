"""FLOPs a training step, its time, achieved TFLOP/s and MFU.

    python -m maskrcnn_tpu_torch.tools.step_flops [BATCH] [--device cpu]

PyTorch counterpart of the JAX package's tools/step_flops.py, on the step
and batch of tools/profile_train.py (the flagship, or the YAML in
MASKRCNN_TPU_PROFILE_CONFIG; BATCH defaults to 8). The FLOPs come from
utils/flops.py (FlopCounterMode over one step: convolutions and matrix
products, forward and backward; the hand kernels and elementwise work are
not counted). XLA's "bytes accessed" has no counterpart there, so no byte
count is printed. The step time is the mean of 5 steps after one warm-up
(profile_train's);
MFU is against the card's dense bf16 peak (utils/flops.py), beside the
card's name and power limit. On the CPU the time is the host's and no MFU
is printed.
"""

import argparse
import time

import torch

from ..utils import flops as flop_count
from ..utils import profiling
from . import profile_train


def main(argv=None):
    parser = argparse.ArgumentParser(description="FLOPs and MFU of the train step")
    parser.add_argument("batch", nargs="?", type=int, default=8)
    parser.add_argument("--device", default=None)
    args = parser.parse_args(argv)
    step, model, batch = profile_train.build_step(args.batch, args.device)
    device = next(model.parameters()).device
    card = profiling.device_line(device)
    flops = flop_count.step_flops(step, batch)
    step(batch)
    profiling.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(profile_train.TIMED):
        step(batch)
    profiling.synchronize(device)
    dt = (time.perf_counter() - t0) / profile_train.TIMED
    print("flops/step: {:.6f} TFLOP (FlopCounterMode: convolutions and matrix products; hand "
          "kernels and elementwise work not counted)".format(flops / 1e12))
    print("bytes accessed: not counted (FlopCounterMode counts no bytes)")
    fields = {"flops_per_step": flops, "step_s": dt}
    print("step: {:.3f} ms  achieved: {:.3f} TF/s [{}]".format(dt * 1e3, flops / dt / 1e12,
                                                             card))
    if device.type == "cuda":
        fields.update(flop_count.mfu_fields(flops, dt, torch.cuda.get_device_name(device)))
        peak = flop_count.device_peak_tflops(torch.cuda.get_device_name(device))
        print("mfu: {} [{}]".format(
            "{:.2%} of {} TF/s dense bf16 peak".format(fields["mfu"], peak) if peak
            else "not measured (no published peak for this card)", card))
    else:
        print("mfu: not measured (CPU run)")
    return fields


if __name__ == "__main__":
    main()
