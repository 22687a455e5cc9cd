"""Finding a cell's parts by name.

BENCHMARK.json names every cell, configuration and metric; each part lives
in a file of its own under benchmark/, found by that name:

* configs/<config>.json: the configuration as it is run ("config"), its
  source, the published YAML's keys ("yaml"), what was changed ("reduced")
  and assumed ("assumed"), and the names of its reference and its counts;
* reference/<reference>.py, named by the configuration's "reference": the
  plain float32 model that decides ``correct``, a module that exports
  REFERENCE_API: the model class ``MaskRCNN(cfg)`` (its ``train_forward``,
  ``infer_forward`` and ``judge``), ``set_precision(model, precision)``,
  ``training_proposals(cfg, batch, rpn)`` and ``calibrate(model, batch)``,
  which sets the body's normalisation from the cell's first batch;
* counts/<counts>.py, named by the configuration's "counts": one function,
  ``step_counts(cfg, batch, hw, train)``, the work of one step at the
  cell's shapes: {"flops": model FLOPs, "<name>_bound_s": the least
  seconds of a mechanism's work, ...}, handed to the readers as
  ``ctx.counts``;
* traffic/<traffic>.json: the parameters of a traffic mix, read by the one
  generator in harness/traffic.py;
* metrics/<metric>.py: the reader of one per-layer metric, a function
  ``read(ctx)`` that returns the metric's value or None where it finds
  nothing to read; metrics that differ only in the part after their last
  dot (mfu.train, mfu.infer) may share one reader, metrics/<stem>.py;
* limits/<workload>.json: the limits of the numbers that decide ``correct``
  in that cell, with the readings they were set from;
* kernels/<family>.json: one family of the program's hand-written kernels,
  for every cell: the substrings of its kernels' names in a trace
  ("kernels", one record a launch; "with", kernels launched beside them)
  and the program's launch counters that count its launches ("counters",
  resolved by program.py alone); no substring of one family contains, or
  lies in, one of another family, so a family added later only adds one.

A later change adds a cell, a configuration, a mix, a metric or a kernel
family by adding such files and their entries in BENCHMARK.json, without
editing a file that is there.
"""

import glob
import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

REFERENCE_API = ("MaskRCNN", "set_precision", "training_proposals", "calibrate")
COUNTS_API = ("step_counts",)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def benchmark(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError("no {} named {!r} in BENCHMARK.json".format(what, name))


def part(config, kind, api):
    """The module benchmark.<kind>.<name> that `config`'s key `kind` names,
    holding every name of `api`; a set-up error naming the configuration
    where the key, the module or a name is missing."""
    name = config.get(kind)
    if not isinstance(name, str) or not name:
        raise RuntimeError("configuration {!r} names no {!r} module".format(config["name"], kind))
    module_name = importlib.util.resolve_name("..{}.{}".format(kind, name), __package__)
    try:
        module = importlib.import_module(module_name)
    except ModuleNotFoundError as e:
        if e.name is None or not module_name.startswith(e.name):
            raise
        raise RuntimeError("configuration {!r}: its {} {!r} has no module {}".format(
            config["name"], kind, name, module_name)) from e
    missing = [f for f in api if not hasattr(module, f)]
    if missing:
        raise RuntimeError("configuration {!r}: {} lacks {}".format(
            config["name"], module_name, ", ".join(missing)))
    return module


def kernel_families():
    """{family: {"kernels": [...], "with": [...], "counters": [...]}} of
    kernels/<family>.json; a set-up error where a substring of one family
    and one of another contain each other, so that a family added by a file
    can never take a kernel from one that is there."""
    out = {}
    for path in sorted(glob.glob(os.path.join(BENCH_DIR, "kernels", "*.json"))):
        fam = load_json(path)
        out[os.path.basename(path)[:-len(".json")]] = {
            "kernels": tuple(fam["kernels"]), "with": tuple(fam.get("with", ())),
            "counters": tuple(fam["counters"])}
    names = [(fam, n) for fam, f in out.items() for n in f["kernels"] + f["with"]]
    for i, (fam_a, a) in enumerate(names):
        for fam_b, b in names[i + 1:]:
            if fam_a != fam_b and (a in b or b in a):
                raise RuntimeError("kernel families {!r} and {!r} overlap: {!r} and {!r}".format(
                    fam_a, fam_b, a, b))
    return out


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic mix,
    metrics and limits loaded, and the configuration's reference and
    counts modules (`reference`, `counts`)."""

    def __init__(self, bench, workload):
        self.workload = by_name(bench["workloads"], workload, "workload")
        self.name = workload
        self.config = load_json(os.path.join(BENCH_DIR, "configs",
                                             self.workload["config"] + ".json"))
        self.traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                              self.workload["traffic"] + ".json"))
        self.limits = load_json(os.path.join(BENCH_DIR, "limits", workload + ".json"))
        self.reference = part(self.config, "reference", REFERENCE_API)
        self.counts = part(self.config, "counts", COUNTS_API)
        self.families = kernel_families()
        self.chips = self.workload["chips"]
        self.end_to_end = [m for m in bench["end_to_end"] if _reports(m, workload)]
        self.per_layer = [m for m in bench["per_layer"] if _reports(m, workload)]

    def reader(self, metric):
        """The read(ctx) function of a per-layer metric: metrics/<name>.py,
        or else the reader of the name's stem, up to its last dot."""
        path = os.path.join(BENCH_DIR, "metrics", metric["name"] + ".py")
        if not os.path.exists(path) and "." in metric["name"]:
            path = os.path.join(BENCH_DIR, "metrics",
                                metric["name"].rsplit(".", 1)[0] + ".py")
        spec = importlib.util.spec_from_file_location("bench_metric_" + metric["name"].replace(
            ".", "_").replace("-", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def _reports(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]
