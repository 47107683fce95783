"""The port's tracer (utils/logging.py) and the spans and counters placed in the program, on the CPU.

The recorder: nesting, the ring, the JSONL export and the clock against
torch.profiler's. DOPRI5's trial-step tally under `full_budget`. The spans
of `evaluate` and of the training loops. Small shapes of data_s123: 8 test
patients, 3 draws; the fused loop at batch 8 over 2 validation windows.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from hybridode_torch.cli.common import build_sim_model
from hybridode_torch.config import DataConfig
from hybridode_torch.data import SyntheticCohort
from hybridode_torch.eval import metrics
from hybridode_torch.fields import doses_from_actions, roche_field
from hybridode_torch.inference import elbo, fused, variational_training_loop
from hybridode_torch.models import priors
from hybridode_torch.solvers import dopri5
from hybridode_torch.utils import logging as tracing

COHORT = os.path.join(os.path.dirname(__file__), os.pardir, "data_s123", "datafile_dose_exp.pkl")


@pytest.fixture(scope="module")
def cohort():
    return SyntheticCohort.load(COHORT, device="cpu")


@pytest.fixture(scope="module")
def model():
    return build_sim_model("hybrid", DataConfig(), mc_size=5)


def _names(spans):
    return [s.name for s in spans]


def test_nesting_sets_parent_and_root_and_a_request_shares_its_id():
    rec = tracing.Recorder()
    with rec.span("request", None) as req:
        with rec.span("a") as a:
            with rec.span("b") as b:
                pass
        c = rec.instant("c")
    with rec.span("other", None) as other:
        late = rec.span("late", req)
        with late:
            pass
    assert _names(rec.spans) == ["b", "a", "c", "request", "late", "other"]
    assert (req.parent, req.root) == (None, req.id)
    assert (a.parent, b.parent, c.parent) == (req.id, a.id, req.id)
    assert {s.root for s in (a, b, c, late)} == {req.id} and other.root == other.id
    assert late.parent == req.id and late.t0 > req.t1  # a span given its parent after that parent ended
    assert req.t0 <= a.t0 <= b.t0 <= b.t1 <= a.t1 <= c.t0 == c.t1 <= req.t1
    assert len({s.id for s in rec.spans}) == 6
    assert rec.last("a") is a and rec.children(req) == [a, c, late]


def test_the_ring_drops_the_oldest_beyond_its_constant():
    rec = tracing.Recorder()
    for i in range(tracing.RING_SIZE + 5):
        rec.instant("tick", i=i)
    assert len(rec.spans) == tracing.RING_SIZE
    assert rec.spans[0].fields["i"] == 5 and rec.spans[-1].fields["i"] == tracing.RING_SIZE + 4


def test_one_jsonl_record_a_span_with_its_fields(tmp_path):
    path = str(tmp_path / "events.jsonl")
    events = tracing.JSONLLogger(path)
    with events.span("capture", graph="step") as cap:
        with tracing.span("inner"):  # the ring's alone: not written
            pass
        cap.fields["late"] = 3
    events.log("val", itr=2, val_loss=1.5)
    with tracing.span("evaluate", None) as request:
        for name in ("encode", "decode", "decode"):
            with tracing.span(name):
                pass
    events.export("evaluate", request, rmse_x=0.5)
    events.close()
    with events.span("window", window=1):  # recorded with no file open
        pass
    recs = [json.loads(ln) for ln in open(path)]
    assert [r["event"] for r in recs] == ["capture", "val", "evaluate"]
    ids = ["t0", "t1", "id", "parent", "root"]
    assert list(recs[0]) == ["t", "event", "graph", "late", "seconds"] + ids
    assert recs[0]["seconds"] == (recs[0]["t1"] - recs[0]["t0"]) / 1e9 and recs[0]["t"] == recs[0]["t1"] / 1e9
    assert list(recs[1]) == ["t", "event", "itr", "val_loss"] + ids and recs[1]["t0"] == recs[1]["t1"]
    assert recs[2]["id"] == request.id and recs[2]["parent"] is None and recs[2]["rmse_x"] == 0.5
    assert sorted(recs[2]["children"]) == ["decode", "encode"]
    assert tracing.RECORDER.last("window").fields == {"window": 1}


def test_a_span_encloses_the_profiler_event_of_its_op():
    """Spans and torch.profiler's events share one clock: a span around `torch.mm` holds its `aten::mm`."""
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("mm") as s:
            torch.mm(a, b)
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    ms = 1_000_000
    assert s.t0 - ms <= ev.start_ns() <= ev.start_ns() + ev.duration_ns() <= s.t1 + ms
    assert s.t1 - s.t0 < 1000 * ms


def _batch_solve(cohort, model, per_row=True):
    params = elbo.init_vi(torch.Generator().manual_seed(0), model, device="cpu")
    batch = cohort.get_split("train", 4, 0)
    mu, log_var = elbo.encode(params, model, batch["measurements"], batch["actions"], batch["masks"])
    z = priors.gaussian_reparameterize(mu, log_var, torch.randn(mu.shape, generator=torch.Generator().manual_seed(2)))
    spec = model.decoder_spec
    args = (params["decoder"]["ode"], doses_from_actions(batch["actions"], spec.step_size))
    with torch.no_grad():
        return dopri5.odeint_dopri5(roche_field, z, spec.ts, args, rtol=spec.rtol, atol=spec.atol,
                                    max_steps=spec.max_steps, per_row=per_row)


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "lockstep"])
def test_full_budget_tally_counts_the_live_and_run_trial_steps(cohort, model, per_row):
    """Live: the solve's own trial steps (Σ n_steps); run: rows x the budget of 256; the solve unchanged."""
    with dopri5.full_budget():
        ys, stats = _batch_solve(cohort, model, per_row)
    tally = torch.zeros(2, dtype=torch.int64)
    with dopri5.full_budget(tally):
        ys_t, stats_t = _batch_solve(cohort, model, per_row)
        with dopri5.full_budget():  # a nested mode without a tally counts nothing
            _batch_solve(cohort, model, per_row)
    _batch_solve(cohort, model, per_row)  # nor does an eager solve outside the mode
    rows = 4 if per_row else 1
    assert torch.equal(ys, ys_t) and all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
                                         for x, y in zip(stats, stats_t))
    assert 0 < int(stats.n_steps.sum()) < rows * 256
    assert tally.tolist() == [int(stats.n_steps.sum()), rows * 256]


def test_full_budget_tally_counts_nothing_under_vmap(cohort, model):
    params = elbo.init_vi(torch.Generator().manual_seed(0), model, device="cpu")
    batch = cohort.get_split("train", 2, 0)
    z = torch.randn(2, 6, generator=torch.Generator().manual_seed(3)) * 0.1
    spec = model.decoder_spec
    ctx = doses_from_actions(batch["actions"], spec.step_size)

    def solve(z_row, times, amounts):
        c = ctx._replace(times=times[None], amounts=amounts[None])
        return dopri5.odeint_dopri5(roche_field, z_row[None], spec.ts, (params["decoder"]["ode"], c),
                                    rtol=1e-5, atol=1e-6, max_steps=64, per_row=True)[0]

    tally = torch.zeros(2, dtype=torch.int64)
    with torch.no_grad(), dopri5.full_budget(tally):
        ys = torch.func.vmap(solve)(z, ctx.times, ctx.amounts)
    assert ys.shape[0] == 2 and tally.tolist() == [0, 0]


def _small_test_fold(cohort, n=8):
    view = copy.copy(cohort)
    view.data_test = {k: v[:, :n] for k, v in cohort.data_test.items()}
    view.test_size = n
    return view


class _NoSpan:
    def __init__(self, *a, **k):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


EVALUATES = ["evaluate", "evaluate_horizon", "evaluate_ensemble", "evaluate_ensemble_horizon"]


@pytest.mark.parametrize("name", EVALUATES)
def test_an_evaluate_call_is_a_root_span_of_encode_decode_score_and_bootstrap(cohort, model, name, monkeypatch):
    params = elbo.init_vi(torch.Generator().manual_seed(0), model, device="cpu")
    fold = _small_test_fold(cohort)
    members = (params, model) * (2 if "ensemble" in name else 1)
    kw = dict(mc_itr=3, device="cpu") | ({} if name.endswith("horizon") else dict(verbose=False))

    def call(fn):
        np.random.seed(0)
        return fn(*members, fold, 4, 5, generator=torch.Generator().manual_seed(1), **kw)

    got = call(getattr(metrics, name))
    request = tracing.RECORDER.last(name)
    assert request.parent is None and request.root == request.id
    children = tracing.RECORDER.children(request)
    assert set(_names(children)) == {"encode", "decode", "score", "bootstrap"}
    per_chunk = 2 if "ensemble" in name else 1  # a decode a member and chunk
    assert _names(children).count("decode") == 2 * per_chunk and _names(children).count("bootstrap") == 1
    assert all(c.root == request.id and request.t0 <= c.t0 <= c.t1 <= request.t1 for c in children)

    monkeypatch.setattr(metrics, "span", _NoSpan)
    want = call(getattr(metrics, name).__wrapped__)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want)
    else:
        assert tuple(got) == tuple(want) and np.isfinite(got).all()


@pytest.mark.parametrize("kernel_device", [False, True], ids=["plain", "dopri5"])
def test_a_decode_span_names_its_route_rows_and_dim(cohort, model, kernel_device, monkeypatch):
    """evaluate's `decode` span carries its rows and width and the route the decoder took: the plain solver on a CPU
    state, and the per-row DOPRI5 kernel's route where the CPU stands for a kernel device."""
    from hybridode_torch.ops import contract

    if kernel_device:
        monkeypatch.setattr(contract, "KERNEL_DEVICES", ("cpu",))
    params = elbo.init_vi(torch.Generator().manual_seed(0), model, device="cpu")
    np.random.seed(0)
    metrics.evaluate(params, model, _small_test_fold(cohort), 4, 5, mc_itr=3, generator=torch.Generator().manual_seed(1),
                     verbose=False, device="cpu")
    decodes = tracing.RECORDER.children(tracing.RECORDER.last("evaluate"))
    decodes = [s for s in decodes if s.name == "decode"]
    route = "dopri5" if kernel_device else "plain"
    assert [s.fields for s in decodes] == [{"rows": 16, "dim": 6, "route": route}] * 2


def test_annotate_adds_fields_to_the_innermost_open_span_of_its_name_alone():
    with tracing.span("decode") as outer:
        with tracing.span("inner") as inner:
            tracing.annotate("decode", route="rk4")  # the innermost open span is not a decode
        tracing.annotate("decode", route="plain")
    tracing.annotate("decode", route="dopri5")  # nothing open
    assert outer.fields == {"route": "plain"} and inner.fields == {}


def test_a_device_counter_sums_what_is_added_on_the_device_and_on_the_host():
    counter = tracing.DeviceCounter(("trial_steps", "accepted_steps"), ("launches", "rows"))
    assert counter.read() == {"launches": 0, "rows": 0, "trial_steps": 0, "accepted_steps": 0}
    t = counter.tensor(torch.device("cpu"))
    assert counter.tensor(torch.device("cpu")) is t and t.dtype == torch.int64 and t.shape == (2,)
    t.add_(torch.tensor([7, 3]))
    counter.add(launches=1, rows=5)
    counter.add(launches=1, rows=2)
    assert counter.read() == {"launches": 2, "rows": 7, "trial_steps": 7, "accepted_steps": 3}


def _train_cohort(cohort):
    c = copy.copy(cohort)
    c.set_val_size(8)
    c.set_train_size(8 + c.test_size + 16)
    return c


def test_fused_loop_records_its_restart_its_windows_and_windows_run_after_it_returned(cohort, model, tmp_path):
    params = elbo.init_vi(torch.Generator().manual_seed(0), model, device="cpu")
    path = str(tmp_path / "events.jsonl")
    fused.fused_training_loop(niters=4, data_generator=_train_cohort(cohort), model=model, params=params,
                              batch_size=8, lr=0.01, test_freq=2, generator=torch.Generator().manual_seed(1),
                              path=str(tmp_path / "ck_"), events_path=path, verbose=False, val_criterion="forecast")
    restart = tracing.RECORDER.last("restart")
    assert restart.parent is None and restart.root == restart.id
    windows = [s for s in tracing.RECORDER.spans if s.name == "window" and s.root == restart.id]
    assert [w.fields["window"] for w in windows] == [1, 2] and all(w.parent == restart.id for w in windows)
    assert all(restart.t0 <= w.t0 <= w.t1 <= restart.t1 for w in windows)
    assert not any(k.endswith(("_live", "_run")) for w in windows for k in w.fields)  # nothing captured here

    run = fused._LAST_RUN
    run.niters = 2
    run.run()  # driven after the loop returned, its log closed
    late = tracing.RECORDER.last("window")
    assert late.parent == restart.id and late.root == restart.id and late.t0 > restart.t1

    recs = [json.loads(ln) for ln in open(path)]
    assert [r["event"] for r in recs] == ["window", "window", "val", "val", "done", "restart"]
    assert all({"t", "t0", "t1", "id", "parent", "root"} <= set(r) and r["root"] == restart.id for r in recs)
    assert [(r["window"], r["itr"]) for r in recs[:2]] == [(1, 2), (2, 4)] and recs[0]["seconds"] > 0
    assert set(recs[2]) >= {"itr", "val_loss", "train_loss"} and set(recs[4]) >= {"wall", "best_on_disk", "captured"}
    assert [r["id"] for r in recs[:2]] == [w.id for w in windows]


def test_host_loop_writes_a_step_span_an_iteration(cohort, model, tmp_path):
    params = elbo.init_vi(torch.Generator().manual_seed(0), model, device="cpu")
    path = str(tmp_path / "events.jsonl")
    variational_training_loop(niters=2, data_generator=_train_cohort(cohort), model=model, params=params,
                              batch_size=8, lr=0.01, test_freq=2, generator=torch.Generator().manual_seed(1),
                              path=str(tmp_path / "ck_"), events_path=path, verbose=False, fused=False)
    steps = [json.loads(ln) for ln in open(path) if '"step"' in ln]
    assert [r["itr"] for r in steps] == [1, 2]
    assert all(r["seconds"] == (r["t1"] - r["t0"]) / 1e9 > 0 and np.isfinite(r["train_loss"]) for r in steps)
    assert steps[0]["t1"] <= steps[1]["t0"] and all(r["parent"] is None for r in steps)
