"""The readings that the GN cell's limits are set from, on the card, in one
process (the benchmark's own runs never run this):

    python3 benchmark/tools/gn_readings.py --workload <GN cell> --seeds 1 2 3 ... [--controls N]

For each seed, tools/readings.py's rows (the program judged as a run judges
it; on the first N seeds the float8 control and that tool's planted
faults), then, on the first N seeds, two faults of a group-norm model, each
planted in the configuration's reference put in the program's place and
judged as the program is:

* fault_mask_head_without_gn: the mask head's group norms pass their input
  through (the mask head before ROI_MASK_HEAD.USE_GN);
* fault_body_gn_16_groups: the stem's and every bottleneck's group norm over
  16 groups in place of the configuration's NUM_GROUPS.

One JSON line a seed and reading, as tools/readings.py prints them.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from benchmark.harness import cells, spec  # noqa: E402
from benchmark.harness import traffic as gen  # noqa: E402
from benchmark.tools import readings  # noqa: E402


class passed_through(torch.nn.Module):
    """A group norm's leaves, kept so that the state dict still loads, with
    nothing done to its input."""

    def __init__(self, gn):
        super().__init__()
        self.scale, self.bias = gn.scale, gn.bias

    def forward(self, x):
        return x


def mask_head_without_gn(model):
    for block in model.roi_heads.mask.feature_extractor.convs:
        block.gn = passed_through(block.gn)


def body_gn_16_groups(model):
    for m in model.backbone.body.modules():
        if hasattr(m, "scale"):  # a group norm (a conv's `groups` are its own)
            m.groups = 16


FAULTS = {"fault_mask_head_without_gn": mask_head_without_gn,
          "fault_body_gn_16_groups": body_gn_16_groups}


class planted:
    """Within the block, the reference's models (run.ref.MaskRCNN) are built
    with `fault` applied to them."""

    def __init__(self, ref, fault):
        self.ref, self.fault = ref, fault

    def __enter__(self):
        self.plain = plain = self.ref.MaskRCNN
        fault = self.fault

        class Faulty(plain):
            def __init__(self, cfg):
                super().__init__(cfg)
                fault(self)

        self.ref.MaskRCNN = Faulty

    def __exit__(self, *exc):
        self.ref.MaskRCNN = self.plain


def gn_faults(run):
    """[(what, numbers, extra)] of FAULTS on the run's seed: the cell's
    state and pool made again from the seed, as the run makes them."""
    pool = gen.train_pool(run.traffic, run.cfg, run.seed, run.device)
    state = run.make_state(pool[0][0])
    n = run.traffic["checked_steps"]
    out = []
    for what, fault in FAULTS.items():
        with planted(run.ref, fault):
            side = cells.reference_train(run, state, pool, n, record=True)
        got, ref = cells.judge_training(run, state, pool, side)
        out.append((what, got, {"losses": side["losses"],
                                "worst": readings.worst_leaves(side, ref),
                                "diag": readings.diagnostics(side, ref)}))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    args = p.parse_args(argv)
    cell = spec.Cell(spec.benchmark(), args.workload)
    spec.part(cell.config, "reference", spec.REFERENCE_API + readings.TOOL_API)
    for k, seed in enumerate(args.seeds):
        run = cells.Run(cell, seed, "cuda")
        t0 = time.perf_counter()
        rows = readings.train_seed(run, k < args.controls)
        torch.cuda.empty_cache()
        if k < args.controls:
            rows += gn_faults(run)
        for what, numbers, extra in rows:
            print(json.dumps({"workload": args.workload, "seed": seed, "what": what,
                              "numbers": numbers, "seconds": time.perf_counter() - t0, **extra}),
                  flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
