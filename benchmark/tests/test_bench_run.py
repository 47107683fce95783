"""Whole runs of every cell at a CPU size (the look for a GPU skipped): the result line, the modules loaded, and
`correct` coming out false when the timed path is broken underneath."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.harness.spec import ROOT
from benchmark.tests import small

WORKLOADS = [w["name"] for w in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_run_is_correct_and_its_line_has_the_contract_keys(workload, trace):
    line = small.run(workload, trace)
    # exactly the contract's keys, and last the compared numbers with their limits, under a key of their own
    assert list(line) == KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in line["metrics"]


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); from benchmark.tests import small; "
            "small.run('sim_hybrid.forecast_dopri5'); "
            "import benchmark.reference.model, benchmark.reference.scores, benchmark.reference.cohort; "
            "print('MODULES', sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    top = json.loads(out.stdout.split("MODULES ")[-1].replace("'", '"'))
    assert "hybridode_torch" in top
    assert not {"jax", "jaxlib", "flax", "hybridode"} & set(top)


def test_the_reference_imports_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "import benchmark.reference.model, benchmark.reference.scores, benchmark.reference.cohort, "
            "benchmark.reference.solvers; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert not {"hybridode_torch", "hybridode", "jax"} & set(json.loads(out.stdout.replace("'", '"')))


def test_a_directory_of_the_benchmark_alone_exits_without_a_result(tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sim_hybrid.train", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


# --- faults planted underneath the timed path ------------------------------------------------------------------


def _halved(fn):
    """`fn(params, model, batch, ..., eps=, eps_kl=)` on the first half of the batch's patients."""

    def half(params, model, batch, *args, eps=None, eps_kl=None, **kw):
        n = batch["measurements"].shape[1] // 2
        batch = {k: v[:, :n] for k, v in batch.items()}
        eps = None if eps is None else eps[:n]
        eps_kl = None if eps_kl is None else eps_kl[:, :n]
        return fn(params, model, batch, *args, eps=eps, eps_kl=eps_kl, **kw)

    return half


def _state_unchanged(monkeypatch):
    from hybridode_torch.inference import fused

    monkeypatch.setattr(fused._Adam, "step", lambda self, grads, keep: None)


def _train_half_batch(monkeypatch):
    from hybridode_torch.inference import fused

    monkeypatch.setattr(fused, "loss_fn", _halved(fused.loss_fn))


def _forecast_half_batch(monkeypatch):
    from hybridode_torch.eval import metrics

    chunk = metrics._eval_chunk

    def half(params, model, batch, t0, expert_dim, eps, eps_point=None):
        n = batch["measurements"].shape[1] // 2
        return chunk(params, model, {k: v[:, :n] for k, v in batch.items()}, t0, expert_dim, eps[:, :n], eps_point)

    monkeypatch.setattr(metrics, "_eval_chunk", half)


def _forecast_answer_altered(monkeypatch):
    from hybridode_torch.eval import metrics

    scores = metrics._point_scores

    def altered(*args):
        out = list(scores(*args))
        out[3] *= 1.01  # rmse_x one percent off
        return tuple(out)

    monkeypatch.setattr(metrics, "_point_scores", altered)


FAULTS = [("sim_hybrid.train", _state_unchanged), ("sim_hybrid.train", _train_half_batch),
          ("real_hybrid.train", _state_unchanged), ("real_hybrid.train", _train_half_batch),
          ("sim_hybrid.forecast_dopri5", _forecast_half_batch),
          ("sim_hybrid.forecast_dopri5", _forecast_answer_altered)]


@pytest.mark.parametrize("workload,fault", FAULTS, ids=[f"{w}-{f.__name__[1:]}" for w, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    torch.manual_seed(0)
    assert small.run(workload)["correct"] is False
