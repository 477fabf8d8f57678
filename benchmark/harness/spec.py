"""``BENCHMARK.json`` and the data files it names, found by name.

A cell names a configuration (its ``file``) and a traffic mix, which is
``benchmark/traffic/<traffic>.json``; its correctness limits are
``benchmark/limits/<cell>.json``; each metric, end to end or per layer, is
read by ``benchmark/metrics/<metric>.py``. A later cell, configuration,
traffic mix or metric is new files and entries, with no edit here.
"""

from __future__ import annotations

import importlib.util
import json
import os


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """One cell of a ``BENCHMARK.json`` and everything it names."""

    def __init__(self, root: str, workload: str):
        self.root = root
        self.bench_dir = os.path.join(root, "benchmark")
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                             f"(has {sorted(cells)})")
        self.cell = cells[workload]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.cell["config"]]
        self.config = load_json(os.path.join(root,
                                             self.config_entry["file"]))
        self.traffic = load_json(os.path.join(
            self.bench_dir, "traffic", self.cell["traffic"] + ".json"))
        self.limits = load_json(os.path.join(
            self.bench_dir, "limits", workload + ".json"))

    def metrics(self, per_layer: bool) -> list:
        """The metric entries of this kind of run; a reader that finds
        nothing to read in this cell returns None."""
        return self.bench["per_layer" if per_layer else "end_to_end"]

    def reader(self, metric: str):
        """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
        path = os.path.join(self.bench_dir, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
