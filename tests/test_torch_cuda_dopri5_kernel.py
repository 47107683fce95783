"""The per-row DOPRI5 kernel (`roche_dopri5_per_row`) against the plain per-row solver on the card.

The cases skip without a GPU. This file imports no JAX, so that the GPU
machine, which has none, runs it:
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_dopri5_kernel.py`.

Inputs at evaluate's shape (2,550 rows, a 15-point grid): latents in the
encoder's range, the dose times and amounts of data_s123's patients, the
port's remainder init. At the CLI's rtol 1e-7 the float32 error estimate is
rounding noise, and the kernel's field rounds otherwise than PyTorch's
unfused operations (its FMAs, its Hill power of 2), so the two solvers take
other steps on most rows: there the kernel is held to a float64 solve of the
same rows, as accurate as the plain solver (ACCURACY). Its steps are held to
the plain solver's on a field whose values are exact in both (EXACT: every
rate 0 but kel 1, W 0), where no rounding of the field can part the step
sequences: outputs and counts bit for bit.
"""

import json
import os

import numpy as np
import pytest
import torch

from hybridode_torch.cli.common import build_sim_model
from hybridode_torch.config import ROCHE_PARAM_NAMES, DataConfig, RocheConfig, dim12_config
from hybridode_torch.data import SyntheticCohort
from hybridode_torch.eval import evaluate
from hybridode_torch.fields import NO_DOSE_TIME, init_roche_field
from hybridode_torch.inference import init_vi
from hybridode_torch.ops import contract, roche_dopri5
from hybridode_torch.solvers import dopri5

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
COHORT = os.path.join(ROOT, "data_s123", "datafile_dose_exp.pkl")
DIM12_COHORT = os.path.join(ROOT, "data_dim12", "datafile_dim12.pkl")
SIM_CONFIG = os.path.join(ROOT, "benchmark", "configs", "lhm_sim_hybrid.json")
B, T = 2550, 15
# The kernel's error against the float64 solve, relative to the row's largest |state| over the grid: averaged over the
# rows' largest, at most ACCURACY times the plain float32 solver's; its largest at most MAX_ACCURACY times the plain
# solver's largest (a maximum over 2,550 rows of two solvers' step sequences); each plus ATOL.
ACCURACY, MAX_ACCURACY, ATOL = 1.25, 4.0, 1e-6
SCORES_RTOL = 1e-6  # evaluate's six scores, kernel against the plain solver
# A field whose values both solvers compute exactly: y' = (0, 0, 0, dose(t) - y3, tanh(b)), the dose
# amount * exp(t_dose - t) after t_dose.
EXACT = RocheConfig(**{name: 0.0 for name in ROCHE_PARAM_NAMES if name not in ("HillCure", "HillPatho", "ec50_patho",
                                                                               "kel")})


@pytest.fixture(scope="module")
def cohort():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU or interpret mode")
    return SyntheticCohort.load(COHORT, device="cpu")


def _inputs(cohort, D=6, hill=None, no_dose=0, config=None, seed=0, rows=B, exact=False):
    gen = torch.Generator().manual_seed(seed)
    config = EXACT if exact else config or (RocheConfig() if hill is None else RocheConfig(HillCure=hill,
                                                                                           HillPatho=hill))
    field = init_roche_field(gen, D, config, device="cpu")
    if exact and D > 4:
        field["ml_net"][0]["w"].data.zero_()
    y0 = torch.exp(0.3 * torch.randn(rows, D, generator=gen)) / 10 + 0.01 * torch.randn(rows, D, generator=gen)
    idx = torch.randint(0, cohort.n_sample, (rows,), generator=gen)
    times = torch.as_tensor(np.asarray(cohort.dose_time)[:, 0], dtype=torch.float32)[idx]
    if no_dose:
        times[::no_dose] = NO_DOSE_TIME
    amounts = torch.as_tensor(np.asarray(cohort.dose_amount), dtype=torch.float32)[idx]
    ml = field["ml_net"][0] if D > 4 else None
    cuda = lambda x: None if x is None else x.detach().to("cuda").contiguous()  # noqa: E731
    return dict(y0=cuda(y0), times=cuda(times), amounts=cuda(amounts),
                expert_params={k: cuda(field["expert"][k]) for k in ROCHE_PARAM_NAMES},
                ml_w=cuda(None if ml is None else ml["w"]), ml_b=cuda(None if ml is None else ml["b"]),
                ts=torch.arange(T, dtype=torch.float32, device="cuda"))


def _exact(inp):
    f64 = {k: (None if v is None else {n: x.double() for n, x in v.items()} if isinstance(v, dict) else v.double())
           for k, v in inp.items()}
    return roche_dopri5.roche_dopri5_per_row_reference(**f64, rtol=1e-10, atol=1e-12, max_steps=4096)[0]


def _errors(ys, exact):
    """Each row's largest error on the grid points both reached, relative to the row's largest |state|."""
    scale = torch.nan_to_num(exact.abs(), nan=0.0).amax(dim=0, keepdim=True).clamp(min=ATOL)
    both = torch.isfinite(ys) & torch.isfinite(exact)
    return torch.where(both, (ys.double() - exact.double()).abs() / scale, 0.0).amax(dim=(0, 2))


def _as_accurate(got, want, exact):
    """The kernel's outputs `got` as accurate against `exact` as the plain solver's `want`."""
    err, err_plain = _errors(got, exact), _errors(want, exact)
    return (err.mean().item() <= ACCURACY * err_plain.mean().item() + ATOL
            and err.max().item() <= MAX_ACCURACY * err_plain.max().item() + ATOL)


def _lhm_sim_hybrid():
    with open(SIM_CONFIG) as f:
        return RocheConfig(**json.load(f)["expert"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [dict(), dict(D=4), dict(hill=1.7), dict(no_dose=5), dict(config="lhm_sim_hybrid"),
                                  dict(D=9), dict(D=10), dict(D=11), dict(D=12)],
                         ids=["evaluate_shape", "expert_only", "hill_1.7", "rows_without_dose", "lhm_sim_hybrid",
                              "latent_9", "latent_10", "latent_11", "latent_12"])
def test_kernel_is_as_accurate_as_the_plain_solver(cohort, case):
    if case.get("config"):
        case = dict(case, config=_lhm_sim_hybrid())
    inp = _inputs(cohort, **case)
    with torch.no_grad():
        got, got_st = roche_dopri5.roche_dopri5_per_row(**inp)
        want, want_st = roche_dopri5.roche_dopri5_per_row_reference(**inp)
        exact = _exact(inp)
    assert got.shape == (T, B, inp["y0"].shape[1]) and got.dtype == torch.float32
    assert torch.isfinite(got).all() and bool(got_st.success.all()) and bool(want_st.success.all())
    assert torch.equal(got[0], inp["y0"])
    assert _as_accurate(got, want, exact)
    budget = dopri5.trial_budget(256)
    assert int(got_st.n_steps.max()) <= budget and bool((got_st.n_accepted <= got_st.n_steps).all())


@pytest.mark.cuda
def test_a_row_that_spends_its_budget_ends_in_nan_and_fails(cohort):
    inp = _inputs(cohort)
    with torch.no_grad():
        got, got_st = roche_dopri5.roche_dopri5_per_row(**inp, max_steps=64)
        want, want_st = roche_dopri5.roche_dopri5_per_row_reference(**inp, max_steps=64)
    spent = ~got_st.success
    assert int(spent.sum()) > B // 2 and int((~want_st.success).sum()) > B // 2
    assert bool((got_st.n_steps[spent] == 64).all()) and bool((got_st.n_accepted <= got_st.n_steps).all())
    assert bool(torch.isnan(got[-1, spent]).all())  # the last grid point never reached
    reached = torch.isfinite(got).all(dim=-1)  # (T, B)
    assert bool(reached[0].all()) and bool((reached[:-1] >= reached[1:]).all())  # a NaN tail, no gap
    assert torch.equal(got_st.success, reached.all(dim=0))
    assert _as_accurate(got, want, _exact(inp))  # on the points both reached


@pytest.mark.cuda
@pytest.mark.parametrize("D,max_steps", [(6, 256), (4, 256), (8, 256), (6, 64), (9, 256), (10, 256), (11, 256),
                                         (12, 256), (12, 64)],
                         ids=["evaluate_shape", "expert_only", "latent_8", "budget_64", "latent_9", "latent_10",
                              "latent_11", "latent_12", "latent_12_budget_64"])
def test_steps_match_the_plain_solver_where_the_step_sequence_does_not_branch(cohort, D, max_steps):
    """On the EXACT field no rounding of the field parts the two solvers' step sequences: the kernel's outputs, NaN
    tails, trial and accepted counts and successes are the plain solver's, bit for bit."""
    inp = _inputs(cohort, D=D, exact=True)
    with torch.no_grad():
        got, got_st = roche_dopri5.roche_dopri5_per_row(**inp, max_steps=max_steps)
        want, want_st = roche_dopri5.roche_dopri5_per_row_reference(**inp, max_steps=max_steps)
    assert int(got_st.n_steps.min()) > 16 and int((got_st.n_steps > got_st.n_accepted).sum()) > B // 10
    assert torch.equal(got_st.n_steps, want_st.n_steps) and torch.equal(got_st.n_accepted, want_st.n_accepted)
    assert torch.equal(got_st.success, want_st.success)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


@pytest.mark.cuda
def test_a_captured_replay_equals_the_eager_call_and_fills_the_tally(cohort):
    inp = _inputs(cohort, rows=50)
    with torch.no_grad():
        eager, eager_st = roche_dopri5.roche_dopri5_per_row(**inp)  # loads the kernel before the capture
        tally = torch.zeros(2, dtype=torch.int64, device="cuda")
        graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        launches = roche_dopri5.roche_dopri5_per_row.launches
        with dopri5.full_budget(tally), torch.cuda.graph(graph, stream=stream):
            got, got_st = roche_dopri5.roche_dopri5_per_row(**inp)
        assert roche_dopri5.roche_dopri5_per_row.launches == launches + 1
        torch.cuda.synchronize()
        assert tally.tolist() == [0, 0]  # the capture runs nothing
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(eager))
    assert torch.equal(got_st.n_steps, eager_st.n_steps) and torch.equal(got_st.success, eager_st.success)
    n = int(eager_st.n_steps.sum())
    assert tally.tolist() == [n, n]
    graph.replay()
    torch.cuda.synchronize()
    assert tally.tolist() == [2 * n, 2 * n]
    graph.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [6, 12])
def test_eager_launches_add_their_rows_steps_to_the_process_counter_and_captured_ones_do_not(cohort, D):
    """`EAGER.read()` grows by each eager launch's rows and the sums of its per-row trial and accepted steps; a
    launch captured into a CUDA graph, and its replays, add nothing to it."""
    inp = _inputs(cohort, D=D, rows=50)
    with torch.no_grad():
        before = roche_dopri5.EAGER.read()
        _, st = roche_dopri5.roche_dopri5_per_row(**inp)
        after = roche_dopri5.EAGER.read()
        assert after["launches"] == before["launches"] + 1 and after["rows"] == before["rows"] + 50
        assert after["trial_steps"] - before["trial_steps"] == int(st.n_steps.sum())
        assert after["accepted_steps"] - before["accepted_steps"] == int(st.n_accepted.sum())
        graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.graph(graph, stream=stream):
            roche_dopri5.roche_dopri5_per_row(**inp)
        graph.replay()
        torch.cuda.synchronize()
        graph.reset()
    assert roche_dopri5.EAGER.read() == after


@pytest.mark.cuda
def test_evaluate_through_the_kernel_matches_the_plain_solver(cohort, monkeypatch):
    """`evaluate` of 50 patients (mc 50, t0 5) at random weights: one launch a chunk, the six scores within
    SCORES_RTOL of the same call with the kernel routed off (`KERNEL_DEVICES` emptied)."""
    data = SyntheticCohort.load(COHORT, device="cuda")
    data.data_test = {k: v[:, :100] for k, v in data.data_test.items()}
    data.test_size = 100
    model = build_sim_model("hybrid", DataConfig(), max_steps=256)
    params = init_vi(torch.Generator().manual_seed(3), model, device="cuda")

    def run():
        np.random.seed(0)
        return np.asarray(evaluate(params, model, data, 50, 5, mc_itr=50, generator=torch.Generator().manual_seed(1),
                                   verbose=False, device="cuda"))

    launches = roche_dopri5.roche_dopri5_per_row.launches
    got = run()
    assert roche_dopri5.roche_dopri5_per_row.launches == launches + 2  # two chunks of 50
    monkeypatch.setattr(contract, "KERNEL_DEVICES", ())
    want = run()
    assert roche_dopri5.roche_dopri5_per_row.launches == launches + 2
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=SCORES_RTOL, atol=0)


@pytest.mark.cuda
def test_a_dim12_forecast_takes_the_kernel_and_matches_the_plain_solver(cohort, monkeypatch):
    """`evaluate` of the dim12 model (obs 80, latent 12) on 50 patients of its cohort (mc 50, t0 5): one launch of
    D = 12, a `decode` span that names it, and the six scores within SCORES_RTOL of the plain solver's."""
    from hybridode_torch.utils import logging as tracing

    data = SyntheticCohort.load(DIM12_COHORT, device="cuda")
    data.data_test = {k: v[:, :50] for k, v in data.data_test.items()}
    data.test_size = 50
    model = build_sim_model("hybrid", dim12_config, max_steps=256)
    params = init_vi(torch.Generator().manual_seed(4), model, device="cuda")

    def run():
        np.random.seed(0)
        return np.asarray(evaluate(params, model, data, 50, 5, mc_itr=50, generator=torch.Generator().manual_seed(1),
                                   verbose=False, device="cuda"))

    launches = roche_dopri5.roche_dopri5_per_row.launches
    got = run()
    assert roche_dopri5.roche_dopri5_per_row.launches == launches + 1
    decode = tracing.RECORDER.last("decode")
    assert decode.fields == {"rows": 2550, "dim": 12, "route": "dopri5"}
    monkeypatch.setattr(contract, "KERNEL_DEVICES", ())
    want = run()
    assert tracing.RECORDER.last("decode").fields["route"] == "plain"
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=SCORES_RTOL, atol=0)

