"""`chip_smoke.py`'s trace helper leaves no profiler events behind (JAX-free; runs on the CPU).

A torch.profiler trace's events hold one another in reference cycles, so a
trace keeps ~10 objects an ATen call alive until Python's next full
collection (6.7 million after one training step on the H100,
`flow_step_study.py`). `_traced` collects them before it returns.
"""

import gc

import torch

import chip_smoke


def test_traced_releases_the_trace():
    def work():
        x = torch.ones(50, 6)
        for _ in range(5000):
            x = torch.tanh(x) * 1.0001
        return x

    chip_smoke._traced(lambda: torch.ones(1), activities=("CPU",))  # the profiler's one-time imports and state
    gc.collect()
    before = len(gc.get_objects())
    out, kernels, launches = chip_smoke._traced(work, activities=("CPU",))
    assert out.shape == (50, 6) and kernels == [] and launches == 0  # no device in a CPU trace
    assert len(gc.get_objects()) - before < 5_000  # a bare trace leaves ~330,000 objects for these 10,000 ops


def test_cohort_check_of_phase_8_fails_loudly_on_a_mismatch():
    """`cohort_faults` holds a generated cohort file against data_s123: silent on the file itself, loud on one
    flipped mask, on latents moved by 1e-4 and on a missing array."""
    import copy
    import os

    from hybridode_torch.utils.pickling import load_pickle

    want = load_pickle(os.path.join(os.path.dirname(__file__), os.pardir, "data_s123", "datafile_dose_exp.pkl"))["state"]
    assert chip_smoke.cohort_faults(want, want) == []

    flipped = copy.deepcopy(want)
    flipped["masks"][3, 7, 2] = 1.0 - flipped["masks"][3, 7, 2]
    assert chip_smoke.cohort_faults(flipped, want) == ["masks is not byte-equal to the committed file's"]

    moved = copy.deepcopy(want)
    moved["latents"] = moved["latents"] + 1e-4
    (fault,) = chip_smoke.cohort_faults(moved, want)
    assert fault.startswith("latents: ") and "beyond rtol=1e-05 atol=1e-06" in fault

    missing = {k: v for k, v in want.items() if k != "dose_time"}
    assert chip_smoke.cohort_faults(missing, want) == ["dose_time is missing"]


def test_phase_9_reads_both_loops_windows_from_their_event_logs():
    """`_loop_record`: the fused loop's `window` records as they are; the host loop's windows between its
    validations, the first from the start of its first step; the graphs' capture seconds."""
    fused = [dict(event="window", window=1, seconds=3.5), dict(event="capture", graph="step", seconds=2.0),
             dict(event="window", window=2, seconds=0.5), dict(event="done", wall=4.0)]
    rec = chip_smoke._loop_record(fused)
    assert rec["window_s"] == [3.5, 0.5] and rec["captures"] == [("step", 2.0)] and rec["done"] == [fused[-1]]
    host = [dict(event="step", t=11.0, seconds=1.0), dict(event="step", t=12.0, seconds=1.0),
            dict(event="val", t=12.5), dict(event="step", t=13.5, seconds=1.0), dict(event="step", t=14.5, seconds=1.0),
            dict(event="val", t=15.0), dict(event="done", wall=5.0)]
    rec = chip_smoke._loop_record(host)
    assert rec["window_s"] == [2.5, 2.5] and rec["captures"] == []
    assert chip_smoke._steady_iter_s(rec, 2) == 1.25


def test_phase_9_switches_the_training_loop_and_restores_the_switch(monkeypatch):
    """Phases 5-8 run the host loop (`HYBRIDODE_FUSED=0`), phase 9 the fused loop; the caller's setting survives."""
    import os

    monkeypatch.delenv("HYBRIDODE_FUSED", raising=False)
    with chip_smoke._fused_loop(False):
        assert os.environ["HYBRIDODE_FUSED"] == "0"
        with chip_smoke._fused_loop(True):
            assert os.environ["HYBRIDODE_FUSED"] == "1"
        assert os.environ["HYBRIDODE_FUSED"] == "0"
    assert "HYBRIDODE_FUSED" not in os.environ


def test_phase_10_reads_the_dryrun_ok_lines():
    """`_dryrun_wait` finds every OK line the 4-rank dryrun prints, and names the one a failed run left out."""
    import subprocess
    import sys

    def fake(lines, rc):
        code = f"import sys; print({lines!r}); sys.exit({rc})"
        return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)

    full = "\n".join(w if w.endswith("OK") else w + "1.0000 OK" for w in chip_smoke.DRYRUN_LINES)
    got = chip_smoke._dryrun_wait(fake(full, 0), 0.0)
    assert got["rc"] == 0 and got["missing"] == [] and len(got["ok_lines"]) == len(chip_smoke.DRYRUN_LINES) == 7
    cut = "\n".join(full.splitlines()[:-1])
    got = chip_smoke._dryrun_wait(fake(cut, 1), 0.0)
    assert got["rc"] == 1 and got["missing"] == ["dryrun_multichip(4): loss="]


def test_kernels_line_counts_the_sharded_evaluation_and_the_dp_training_path():
    """The `kernels` JSON carries phase 10's paths beside the others: `evaluate_sharded` (4 launches, one a chunk)
    and the DP fused training (0); and phases 5 and 8's new paths: the native generator, the lockstep restarts
    batched and in turn, the checkpoint_steps probe (0 each); from phase 3b, the per-row DOPRI5 kernel's
    numbers at evaluate's shape and its one launch a forecast request; and from phase 3c and the training paths,
    the DOPRI5 pair with gradients' numbers and its launches on every training path, which `grad_route_faults`
    holds to the route; from phase 3d and the real-track paths of phases 6 and 9, the real AB4 pair's and the no-grad
    AB4 kernel's numbers and launches, which `ab4_route_faults` holds to each kernel's route."""
    row = dict(max_abs_err=1e-6, ms=0.19, device_ms=0.06, plain_ms=260.0, bound_ms=0.0014, bound_by="operations")
    grad_row = dict(row, err=[2e-6, 3e-6, 1e-6], forward_device_ms=0.03, backward_device_ms=0.02)
    on, off = 3, 0
    rk4 = dict(roche_rk4_launches=4, roche_dopri5_grad_launches=off)
    none = dict(roche_rk4_launches=0, roche_dopri5_grad_launches=off)
    ab4 = {p: on for p in ("run_real_hybrid", "run_real_held", "run_real_expert")}
    other = dict(run_real_neural=off, run_real_2nd=off, run_real_tlstm=off, run_real_gruode=off)
    real = dict(none, roche_real_ab4_grad_launches=dict(ab4, **other, run_real_ensemble=off, run_real_residual=off,
                                                        predict_test=off),
                roche_real_ab4_launches=dict(ab4, **other, run_real_ensemble=2, run_real_residual=2, predict_test=2))
    trained = dict(none, roche_dopri5_grad_launches=on)
    more = dict(evaluate_horizon=rk4, evaluate_ensemble_horizon=rk4, flow_evaluate=rk4, flow=trained,
                members=dict(none, roche_dopri5_grad_launches=dict(expert=on, neural=off)), ensemble=none,
                residual=none, run_eval=none)
    fused = dict(roche_rk4_launches=dict(gpu=0, vmap=0),
                 roche_dopri5_grad_launches=dict(gpu=on, gpu_host_loop=on, real=off, vmap=off, seq=on),
                 roche_real_ab4_grad_launches=dict(real=on, real_vmap=off),
                 roche_real_ab4_launches=dict(real=on, real_vmap=off))
    ab4_row = dict(row, record_device_ms=0.3, backward_device_ms=0.45, bound_ms=0.003, solve_ms=0.4,
                   solve_device_ms=0.2, solve_plain_ms=110.0, solve_bound_ms=0.001, solve_is_record=True,
                   rel_diff_plain=dict(solve=6e-7, trajectory=7e-7, y0=1e-5, kel=2e-5))
    line = chip_smoke.kernels_line([row], 4, dict(trained, checkpoint_steps=none), real, more,
                                   dict(train=none, create_data=dict(none, native=none),
                                        restarts=dict(vmap=none, seq=none)),
                                   fused, dict(evaluate_sharded=rk4, dp_fused=trained),
                                   [dict(row, err=2e-4), dict(row, err=3e-4)], dict(launches_per_request=1.0),
                                   [grad_row, dict(grad_row, err=[4e-6, 0.0, 0.0])],
                                   [ab4_row, dict(ab4_row, rel_diff_plain=dict(solve=8e-7, trajectory=5e-7, y0=3e-5))])
    k, dopri5, grad, real_ab4, solve_ab4 = line["kernels"]
    paths = k["launches_by_path"]
    assert k["launches"] == 4 and paths["evaluate_sharded"] == 4
    assert paths["fused_dp"] == 0 and paths["fused_vmap"] == 0
    assert [paths[p] for p in ("create_data_native", "lockstep_vmap", "lockstep_seq", "checkpoint_steps_probe")] == \
        [0, 0, 0, 0]
    assert set(k) >= {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                      "bound_by", "library_ms"}
    assert dopri5["name"] == "roche_dopri5" and dopri5["launches_per_forecast_request"] == 1.0
    assert dopri5["max_err"] == 3e-4 and dopri5["device_ms"] == 0.06
    assert grad["name"] == "roche_dopri5_grad" and grad["max_err"] == 4e-6 and grad["bound_ms"] == 0.0014
    assert {p for p, n in grad["launches_by_path"].items() if n} == set(chip_smoke.GRAD_ROUTE_PATHS)
    assert chip_smoke.grad_route_faults(grad["launches_by_path"]) == []
    faults = chip_smoke.grad_route_faults(dict(grad["launches_by_path"], run_simulation=0, run_simulation_lockstep=2))
    assert [f.split(":")[0] for f in faults] == ["run_simulation", "run_simulation_lockstep"]
    assert real_ab4["name"] == "roche_real_ab4_grad" and real_ab4["bound_ms"] == 0.003
    assert real_ab4["max_err"] == 3e-5
    assert {p for p, n in real_ab4["launches_by_path"].items() if n} == \
        set(chip_smoke.AB4_ROUTE_PATHS["roche_real_ab4_grad"])
    assert real_ab4["launches_by_path"]["predict_test"] == real_ab4["launches_by_path"]["fused_real_vmap"] == 0
    assert chip_smoke.ab4_route_faults(real_ab4["launches_by_path"]) == []
    faults = chip_smoke.ab4_route_faults(dict(real_ab4["launches_by_path"], fused_real=0, predict_test=1))
    assert sorted(f.split(":")[0] for f in faults) == ["fused_real", "predict_test"]
    assert solve_ab4["name"] == "roche_real_ab4" and solve_ab4["max_err"] == 8e-7 and solve_ab4["solve_is_record"]
    assert (solve_ab4["device_ms"], solve_ab4["plain_ms"], solve_ab4["bound_ms"]) == (0.2, 110.0, 0.001)
    assert {p for p, n in solve_ab4["launches_by_path"].items() if n} == \
        set(chip_smoke.AB4_ROUTE_PATHS["roche_real_ab4"])
    assert chip_smoke.ab4_route_faults(solve_ab4["launches_by_path"], "roche_real_ab4") == []
    faults = chip_smoke.ab4_route_faults(dict(solve_ab4["launches_by_path"], fused_real=0, fused_real_vmap=1),
                                         "roche_real_ab4")
    assert sorted(f.split(":")[0] for f in faults) == ["fused_real", "fused_real_vmap"]


def test_phase_8_holds_the_native_generator_against_data_s123():
    """`_generate_native` (the host's C++ solve; no card needed): the seed-123 cohort is data_s123's, and its
    latents lie within NATIVE_RTOL / NATIVE_ATOL of a reference state's (here the committed file's own)."""
    import os

    import pytest

    from hybridode_torch import native
    from hybridode_torch.utils.pickling import load_pickle

    if not native.available():
        pytest.skip("the native library does not build here")
    want = load_pickle(os.path.join(os.path.dirname(__file__), os.pardir, "data_s123", "datafile_dose_exp.pkl"))["state"]
    got = chip_smoke._generate_native(want)
    assert got["faults"] == [] and got["latents_beyond_tol_vs_gpu"] == 0 and got["seconds"] > 0
