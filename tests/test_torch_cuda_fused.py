"""The fused loop's CUDA graphs on the card: captured against the same loop uncaptured, batched restarts.

The cases skip without a GPU. This file imports no JAX, so that the GPU
machine, which has none, runs it:
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_fused.py`.

Small shapes at full width: the hybrid on data_s123 (obs 20, latent 6,
per-patient DOPRI5, max_steps 256) at batch 8 with 16 validation patients,
and the real hybrid on data_real/ (latent 20, two explicit-Adams steps an
hour) at batch 16 with 32. "Uncaptured" is the same fused loop on the same
card with `captures` forced off: the same kernels, eager. Tolerances: curves
rtol 1e-5, parameters rtol 1e-4 / atol 1e-6, as the CPU parity tests hold
the fused loop to the host loop, because cuBLAS may pick other kernels for a
capture stream's workspace than for the default stream's, and a batched
(vmapped) matrix product sums in another order than R separate ones.
"""

import json
import os

import numpy as np
import pytest
import torch

from hybridode_torch.cli.common import build_real_model, build_sim_model, restart_generators
from hybridode_torch.config import DataConfig
from hybridode_torch.data import RealCohort, SyntheticCohort
from hybridode_torch.inference import fused, init_vi, variational_training_loop
from hybridode_torch.ops import roche_rk4
from hybridode_torch.solvers import dopri5

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
COHORT = os.path.join(ROOT, "data_s123", "datafile_dose_exp.pkl")
REAL = os.path.join(ROOT, "data_real")
CURVE_RTOL, PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _sim():
    c = SyntheticCohort.load(COHORT, device="cuda")
    c.set_val_size(16)
    c.set_train_size(16 + c.test_size + 64)  # a sample of 64 training patients
    return c


def _real():
    c = RealCohort(REAL, val_size=32, test_size=1000, device="cuda")
    c.split_sample()
    c.set_train_size(64)
    return c


def _train(tmp_path, name, model, cohort, batch_size, monkeypatch=None, capture=True, **kw):
    if monkeypatch is not None and not capture:
        monkeypatch.setattr(fused, "captures", lambda *a: False)
    params = init_vi(torch.Generator().manual_seed(0), model, device="cuda")
    events = str(tmp_path / f"{name}.jsonl")
    args = dict(niters=6, test_freq=2, lr=0.01, early_stop=10, shuffle=False, val_criterion="forecast",
                verbose=False) | kw
    out = variational_training_loop(data_generator=cohort, model=model, params=params, batch_size=batch_size,
                                    generator=torch.Generator().manual_seed(1), path=str(tmp_path / name) + "_",
                                    events_path=events, fused=True, **args)
    if monkeypatch is not None:
        monkeypatch.undo()
    torch.cuda.synchronize()
    recs = [json.loads(ln) for ln in open(events)]
    curve = [(r["itr"], r["val_loss"], r["train_loss"]) for r in recs if r["event"] == "val"]
    return out, params, curve, recs


def _close(a, b):
    for (k, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(x, y, rtol=PARAM_RTOL, atol=PARAM_ATOL, msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sim", "flow"])
def test_captured_step_matches_the_uncaptured_fused_loop(cuda_device, tmp_path, monkeypatch, kind):
    model = build_sim_model("hybrid", DataConfig(), flow=kind == "flow", mc_size=10)
    roche_rk4.roche_rk4_trajectory.launches = 0
    got, p_got, curve, recs = _train(tmp_path, "graph", model, _sim(), 8)
    want, p_want, want_curve, want_recs = _train(tmp_path, "eager", model, _sim(), 8, monkeypatch, capture=False)
    assert roche_rk4.roche_rk4_trajectory.launches == 0
    assert sorted(r["graph"] for r in recs if r["event"] == "capture") == ["step", "validation"]
    assert not [r for r in want_recs if r["event"] == "capture"]
    assert [r["captured"] for r in recs if r["event"] == "done"] == [True]
    assert [c[0] for c in curve] == [2, 4, 6] and np.isfinite(np.asarray(curve)).all()
    np.testing.assert_allclose(curve, want_curve, rtol=CURVE_RTOL)
    np.testing.assert_allclose(got[1], want[1], rtol=CURVE_RTOL)
    _close(p_got, p_want)  # the final parameters
    _close(got[0], want[0])  # the best, reloaded


@pytest.mark.cuda
def test_window_spans_count_the_trial_steps_of_the_step_graph(cuda_device, tmp_path, monkeypatch):
    """Two windows of the sim step graph at lr 0 (every step at the same parameters): each window span's
    `step_trials_live` is an eager recount of its batches (the same loop uncaptured, each step's solves counted
    under `full_budget` with a tally of their own), `step_trials_run` its replays x 8 rows x the budget of 256, and
    the step and the validation graphs each have a `warmup` span."""
    model = build_sim_model("hybrid", DataConfig(), mc_size=10)
    kw = dict(niters=4, test_freq=2, lr=0.0)
    _, _, _, recs = _train(tmp_path, "graph", model, _sim(), 8, **kw)
    windows = [r for r in recs if r["event"] == "window"]
    assert sorted(r["graph"] for r in recs if r["event"] == "warmup") == ["step", "validation"]

    counts, step = [], fused._Run._step

    def counted(run):
        tally = torch.zeros(2, dtype=torch.int64, device="cuda")
        with dopri5.full_budget(tally):
            step(run)
        counts.append(tally.tolist())

    monkeypatch.setattr(fused._Run, "_step", counted)
    _train(tmp_path, "eager", model, _sim(), 8, monkeypatch, capture=False, **kw)
    assert len(windows) == 2 and len(counts) == 4
    for w, r in enumerate(windows):
        live, run = (sum(c[k] for c in counts[2 * w:2 * w + 2]) for k in (0, 1))
        assert (r["step_trials_live"], r["step_trials_run"]) == (live, run) == (live, 2 * 8 * 256)
        assert 0 < r["step_trials_live"] < r["step_trials_run"]
        assert r["val_trials_run"] == 2 * 8 * 256 and 0 < r["val_trials_live"] < r["val_trials_run"]


@pytest.mark.cuda
def test_real_step_and_validation_are_captured(cuda_device, tmp_path, monkeypatch):
    c = _real()
    model = build_real_model("hybrid", c.obs_dim, c.action_dim, c.static_dim, c.t_max, c.step_size, ode_step_div=2)
    got, p_got, curve, recs = _train(tmp_path, "graph", model, c, 16, train_expert=True, val_criterion="elbo")
    want, p_want, want_curve, _ = _train(tmp_path, "eager", model, _real(), 16, monkeypatch, capture=False,
                                         train_expert=True, val_criterion="elbo")
    assert sorted(r["graph"] for r in recs if r["event"] == "capture") == ["step", "validation"]
    assert len(curve) == 3 and np.isfinite(np.asarray(curve)).all()
    np.testing.assert_allclose(curve, want_curve, rtol=CURVE_RTOL)
    _close(p_got, p_want)


@pytest.mark.cuda
def test_vmap_captured_matches_sequential_captured(cuda_device, tmp_path):
    model = build_sim_model("hybrid", DataConfig(), mc_size=10)
    main = torch.Generator().manual_seed(5)
    pairs = [restart_generators(main) for _ in range(2)]
    states = [(a.get_state(), b.get_state()) for a, b in pairs]
    kw = dict(niters=4, batch_size=8, lr=0.01, test_freq=2, early_stop=10, shuffle=False, val_criterion="forecast",
              verbose=False)
    params, best, _ = fused.fused_experiment_loop(data_generator=_sim(), model=model, restart_generators=pairs,
                                                  path=str(tmp_path / "vmap_"), device="cuda",
                                                  events_path=str(tmp_path / "vmap.jsonl"), **kw)
    recs = [json.loads(ln) for ln in open(tmp_path / "vmap.jsonl")]
    assert sorted(r["graph"] for r in recs if r["event"] == "capture") == ["step", "validation"]
    seq_best = 1e9
    for (s_init, s_train) in states:
        g_init, g_train = torch.Generator(), torch.Generator()
        g_init.set_state(s_init)
        g_train.set_state(s_train)
        seq, seq_best, _ = fused.fused_training_loop(data_generator=_sim(), model=model,
                                                     params=init_vi(g_init, model, device="cuda"),
                                                     generator=g_train, path=str(tmp_path / "seq_"),
                                                     best_on_disk=seq_best, **kw)
    vals = [r for r in recs if r["event"] == "val"]
    assert len(vals) == 4 and np.isfinite([r["val_loss"] for r in vals]).all()
    np.testing.assert_allclose(best, seq_best, rtol=CURVE_RTOL)
    _close(params, seq)


@pytest.mark.cuda
def test_a_capture_that_fails_raises(cuda_device, tmp_path, monkeypatch):
    """A host read inside the step cannot be captured: the loop raises, and neither trains on eagerly nor
    falls back to the host loop (no checkpoint, no `done` event)."""
    loss_fn = fused.loss_fn

    def reads_the_host(*args, **kw):
        loss = loss_fn(*args, **kw)
        float(loss)  # a device-to-host copy: not allowed while a stream is captured
        return loss

    monkeypatch.setattr(fused, "loss_fn", reads_the_host)
    model = build_sim_model("hybrid", DataConfig(), mc_size=10)
    with pytest.raises(RuntimeError, match="capturing the fused loop's step into a CUDA graph failed"):
        _train(tmp_path, "fails", model, _sim(), 8)
    assert not os.path.exists(str(tmp_path / "fails_") + model.model_name)
    assert '"done"' not in open(tmp_path / "fails.jsonl").read()
