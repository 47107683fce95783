"""What one run measures, found by name: the cell in BENCHMARK.json, its configuration, traffic mix, limits and
per-layer metric readers, and the generator of the mix's kind, each a file of its own under the benchmark's
folder. (The modules of a configuration's kind are found by `reference.model.family`, `costs.family` and
`harness.port.family`.)"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Spec:
    workload: dict
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list
    peaks: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    def reports(self, metric: dict) -> bool:
        """Whether this cell reports `metric`: named in its `workloads`, or, without that key, wherever the
        end-to-end metric it moves (or, for an end-to-end metric, every cell) is reported."""
        if "workloads" in metric:
            return self.name in metric["workloads"]
        if "moves" in metric:
            return any(m["name"] == metric["moves"] and self.reports(m) for m in self.end_to_end)
        return True

    def metrics(self, trace: bool) -> list:
        return [m for m in (self.per_layer if trace else self.end_to_end) if self.reports(m)]


def load(workload: str, root: str = ROOT, bench_dir: str = BENCH_DIR) -> Spec:
    """The cell named `workload` of `<root>/BENCHMARK.json`; raises KeyError for an unknown one."""
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return Spec(workload=cell, config=read_json(os.path.join(root, config["file"])),
                mix=read_json(os.path.join(bench_dir, "traffic", cell["traffic"] + ".json")),
                limits=read_json(os.path.join(bench_dir, "limits", workload + ".json")),
                end_to_end=bench["end_to_end"], per_layer=bench["per_layer"],
                peaks=read_json(os.path.join(bench_dir, "peaks.json")))


def generator(kind: str):
    """The module `generators/<kind>.py` that drives a traffic mix of that kind."""
    return importlib.import_module(f"benchmark.generators.{kind}")


def reader(metric: str, bench_dir: str = BENCH_DIR):
    """The `read(record) -> float | None` of `metrics/<metric>.py`."""
    path = os.path.join(bench_dir, "metrics", metric + ".py")
    module_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module.read
