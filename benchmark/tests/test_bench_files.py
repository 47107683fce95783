"""The benchmark is driven by files found by name: every file loads, and a new file adds a cell or a metric."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import costs
from benchmark.harness import port, spec as spec_mod
from benchmark.reference import model

ROOT = spec_mod.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_loads_its_files_by_name(workload):
    spec = spec_mod.load(workload)
    assert spec.config["name"] == spec.workload["config"]
    assert callable(spec_mod.generator(spec.mix["kind"]).run)
    assert callable(port.family(spec.config).model) and callable(costs.family(spec.config).step_forward)
    assert callable(model.family(spec.config).loss)
    assert spec.limits and all("limit" in v for v in spec.limits.values())
    reported = {m["name"] for m in spec.metrics(False)}
    assert "setup_s" in reported and len(reported) >= 2
    assert spec.metrics(True), "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader_that_finds_nothing_in_an_empty_run(metric):
    read = spec_mod.reader(metric)
    spec = spec_mod.load(next(w for w in WORKLOADS if spec_mod.load(w).reports(
        next(m for m in BENCH["per_layer"] if m["name"] == metric))))
    assert read({"spec": spec, "device_kind": "NVIDIA H100 80GB HBM3"}) is None


def _digests(folder):
    out = {}
    for base, _, files in os.walk(folder):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, folder)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_add_a_cell_and_a_metric_without_editing_a_file(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root / "benchmark")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "sim_hybrid.forecast_dopri5_mc10", "config": "lhm_sim_hybrid",
                               "traffic": "forecast_dopri5_mc10", "chips": 1, "why": "fewer draws"})
    next(m for m in bench["end_to_end"] if m["name"] == "forecast_patients_per_s")["workloads"].append(
        "sim_hybrid.forecast_dopri5_mc10")
    bench["per_layer"].append({"name": "requests_done", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "eval/metrics evaluate",
                               "moves": "forecast_patients_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((root / "benchmark/traffic/forecast_dopri5.json").read_text())
    mix["mc_itr"] = 10
    (root / "benchmark/traffic/forecast_dopri5_mc10.json").write_text(json.dumps(mix))
    (root / "benchmark/limits/sim_hybrid.forecast_dopri5_mc10.json").write_text('{"scores": {"limit": 1e-3}}')
    (root / "benchmark/metrics/requests_done.py").write_text("def read(rec):\n    return rec.get('requests')\n")

    spec = spec_mod.load("sim_hybrid.forecast_dopri5_mc10", root=str(root), bench_dir=str(root / "benchmark"))
    assert spec.mix["mc_itr"] == 10
    assert "requests_done" in [m["name"] for m in spec.metrics(True)]
    assert spec_mod.reader("requests_done", bench_dir=str(root / "benchmark"))({"requests": 7}) == 7
    after = _digests(root / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


def test_new_files_add_a_traffic_kind_and_a_configuration_kind(tmp_path):
    """A configuration of a new kind and a mix of a new kind, added as files alone, run as a cell: the harness finds
    the new kind's reference, costs, builder and generator by name, and no file that was there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("hybridode_torch", "data_s123"):
        os.symlink(os.path.join(ROOT, name), root / name)
    before = _digests(root / "benchmark")
    bench = json.loads(json.dumps(BENCH))
    sim = next(c for c in bench["configs"] if c["name"] == "lhm_sim_hybrid")
    bench["configs"].append(dict(sim, name="lhm_sim_twin", file="benchmark/configs/lhm_sim_twin.json"))
    bench["workloads"].append({"name": "sim_twin.forecast", "config": "lhm_sim_twin", "traffic": "forecast_twin",
                               "chips": 1, "why": "a new configuration kind under a new traffic kind"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sim_hybrid.forecast_dopri5" in m.get("workloads", ()):
            m["workloads"].append("sim_twin.forecast")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cfg = json.loads((root / "benchmark/configs/lhm_sim_hybrid.json").read_text())
    (root / "benchmark/configs/lhm_sim_twin.json").write_text(json.dumps(dict(cfg, name="lhm_sim_twin",
                                                                               kind="sim_twin")))
    for folder in ("reference", "costs", "builders"):
        (root / f"benchmark/{folder}/sim_twin.py").write_text("from .sim import *  # noqa: F401,F403\n")
    (root / "benchmark/generators/forecast_twin.py").write_text(
        "from .forecast import *  # noqa: F401,F403\nTWIN = True\n")
    mix = json.loads((root / "benchmark/traffic/forecast_dopri5.json").read_text())
    (root / "benchmark/traffic/forecast_twin.json").write_text(json.dumps(dict(mix, kind="forecast_twin")))
    limits = root / "benchmark/limits"
    shutil.copy(limits / "sim_hybrid.forecast_dopri5.json", limits / "sim_twin.forecast.json")

    code = ("import json, sys; from benchmark.tests import small; line = small.run('sim_twin.forecast', trace=1); "
            "from benchmark import costs; from benchmark.harness import spec; s = spec.load('sim_twin.forecast'); "
            "print('RESULT', json.dumps(dict(line=line, flops=costs.forecast_request(s.config, s.mix, None), "
            "twin=spec.generator('forecast_twin').TWIN, files=[sys.modules[m].__file__ for m in ("
            "'benchmark.reference.sim_twin', 'benchmark.costs.sim_twin', 'benchmark.builders.sim_twin', "
            "'benchmark.generators.forecast_twin')])))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=root,
                         env=dict(os.environ, PYTHONPATH=str(root)))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.split("RESULT ")[-1])
    assert got["line"]["correct"] is True and got["line"]["attempted"] > 0
    assert got["twin"] is True and all(f.startswith(str(root)) for f in got["files"])
    sim_cfg = json.load(open(os.path.join(ROOT, "benchmark/configs/lhm_sim_hybrid.json")))
    assert got["flops"] == costs.forecast_request(sim_cfg, mix, None)
    after = _digests(root / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


def test_contract_limits_of_the_file():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert all(len(w["why"]) <= 200 for w in BENCH["workloads"] + BENCH["configs"])
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"]
        # every key changed from the source is in `reduced`, with the source's value under `published`
        assert sorted(k for k, v in cfg["published"].items() if cfg[k] != v) == sorted(c["reduced"])
