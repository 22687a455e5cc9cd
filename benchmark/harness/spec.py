"""Finding a cell's parts by name.

BENCHMARK.json names every cell, configuration and metric; each part lives
in a file of its own under benchmark/, found by that name:

* configs/<config>.json: the configuration as it is run ("config"), its
  source, the published YAML's keys ("yaml"), what was changed ("reduced")
  and assumed ("assumed");
* traffic/<traffic>.json: the parameters of a traffic mix, read by the one
  generator in harness/traffic.py;
* metrics/<metric>.py: the reader of one per-layer metric, a function
  ``read(ctx)`` that returns the metric's value or None where it finds
  nothing to read; metrics that differ only in the part after their last
  dot (mfu.train, mfu.infer) may share one reader, metrics/<stem>.py;
* limits/<workload>.json: the limits of the numbers that decide ``correct``
  in that cell, with the readings they were set from.

A later change adds a cell, a configuration, a mix or a metric by adding
such files and their entries in BENCHMARK.json, without editing a file
that is there.
"""

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


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


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic mix,
    metrics and limits loaded."""

    def __init__(self, bench, workload):
        self.workload = by_name(bench["workloads"], workload, "workload")
        self.name = workload
        self.config = load_json(os.path.join(BENCH_DIR, "configs", self.workload["config"] + ".json"))
        self.traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                              self.workload["traffic"] + ".json"))
        self.limits = load_json(os.path.join(BENCH_DIR, "limits", workload + ".json"))
        self.chips = self.workload["chips"]
        self.end_to_end = [m for m in bench["end_to_end"] if _reports(m, workload)]
        self.per_layer = [m for m in bench["per_layer"] if _reports(m, workload)]

    def reader(self, metric):
        """The read(ctx) function of a per-layer metric: metrics/<name>.py,
        or else the reader of the name's stem, up to its last dot."""
        path = os.path.join(BENCH_DIR, "metrics", metric["name"] + ".py")
        if not os.path.exists(path) and "." in metric["name"]:
            path = os.path.join(BENCH_DIR, "metrics", metric["name"].rsplit(".", 1)[0] + ".py")
        spec = importlib.util.spec_from_file_location("bench_metric_" + metric["name"].replace(
            ".", "_").replace("-", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def _reports(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]
