"""The per-row DOPRI5 solve with gradients (`roche_dopri5_per_row_grad`) on the card.

The cases skip without a GPU. This file imports no JAX, so that the GPU
machine, which has none, runs it:
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_dopri5_grad_kernel.py`.

The forward is the recording solve, whose outputs must be the no-grad
kernel's bit for bit. The backward replays each row's recorded accepted
steps, each recomputed from its start as `dopri5.replay_step` recomputes it:
its gradients are held to PyTorch's autograd through `replay_step` over the
same records (values from the records, gradients from the replay), within
GRAD_RTOL, a float32 tolerance (the kernel's field rounds with FMAs where
PyTorch's does not, and the two sum a gradient's terms in other orders).
Against a float64 plain solve the kernel's gradients must be as accurate as
the plain float32 solver's autograd (ACCURACY). A training step on the route
must stay within the benchmark cell's own limits of the plain route.
"""

import copy
import json
import os
import statistics

import numpy as np
import pytest
import torch

from hybridode_torch.cli.common import build_sim_model
from hybridode_torch.config import ROCHE_PARAM_NAMES, DataConfig, RocheConfig
from hybridode_torch.data import SyntheticCohort
from hybridode_torch.fields import DoseContext, init_roche_field, roche_field
from hybridode_torch.inference import elbo, init_vi
from hybridode_torch.models import decoders
from hybridode_torch.ops import roche_dopri5
from hybridode_torch.solvers import dopri5

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
COHORT = os.path.join(ROOT, "data_s123", "datafile_dose_exp.pkl")
LIMITS = os.path.join(ROOT, "benchmark", "limits", "sim_hybrid.train.json")
T = 15
MAX_STEPS = 128  # rows started at LATE_STATE need ~150 trial steps: they spend the budget and leave grid points unreached
LATE_STATE, LATE_EVERY = 3.0, 7
GRAD_RTOL = 1e-4  # |kernel - replay| over |replay|, in norm, for each of dy0, dW, db
ACCURACY, GRAD_ATOL = 4.0, 1e-5  # against float64: kernel's error <= ACCURACY x the plain solver's + GRAD_ATOL


@pytest.fixture(scope="module")
def cohort():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU or interpret mode")
    return SyntheticCohort.load(COHORT, device="cpu")


def _inputs(cohort, D, rows, seed=0, late=True):
    gen = torch.Generator().manual_seed(seed)
    field = init_roche_field(gen, D, RocheConfig(), device="cpu")
    y0 = torch.exp(0.3 * torch.randn(rows, D, generator=gen)) / 10 + 0.01 * torch.randn(rows, D, generator=gen)
    if late:
        y0[LATE_EVERY - 1 :: LATE_EVERY] = LATE_STATE
    idx = torch.randint(0, cohort.n_sample, (rows,), generator=gen)
    times = torch.as_tensor(np.asarray(cohort.dose_time)[:, 0], dtype=torch.float32)[idx]
    amounts = torch.as_tensor(np.asarray(cohort.dose_amount), dtype=torch.float32)[idx]
    ml = field["ml_net"][0] if D > 4 else None
    cuda = lambda x: None if x is None else x.detach().to("cuda").contiguous()  # noqa: E731
    return dict(y0=cuda(y0), times=cuda(times), amounts=cuda(amounts),
                expert_params={k: cuda(field["expert"][k]) for k in ROCHE_PARAM_NAMES},
                ml_w=cuda(None if ml is None else ml["w"]), ml_b=cuda(None if ml is None else ml["b"]),
                ts=torch.arange(T, dtype=torch.float32, device="cuda"))


def _g_out(shape, seed=1):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to("cuda")


def _with_leaves(inp, dtype=torch.float32):
    """`inp` in `dtype` with y0, ml_w and ml_b as fresh leaves that require grad -> (inputs, leaves)."""
    cast = lambda x: None if x is None else x.detach().to(dtype).clone()  # noqa: E731
    out = dict(inp, y0=cast(inp["y0"]).requires_grad_(), times=cast(inp["times"]), amounts=cast(inp["amounts"]),
               expert_params={k: cast(v) for k, v in inp["expert_params"].items()}, ts=cast(inp["ts"]))
    if inp["ml_w"] is not None:
        out.update(ml_w=cast(inp["ml_w"]).requires_grad_(), ml_b=cast(inp["ml_b"]).requires_grad_())
    leaves = [out["y0"]] + ([out["ml_w"], out["ml_b"]] if inp["ml_w"] is not None else [])
    return out, leaves


def _kernel_grads(inp, g_out, max_steps=MAX_STEPS):
    x, leaves = _with_leaves(inp)
    ys, st = roche_dopri5.roche_dopri5_per_row_grad(**x, max_steps=max_steps)
    return ys.detach(), st, torch.autograd.grad(ys, leaves, g_out)


def _replay_grads(inp, record, n_acc, g_out, rtol=1e-7, atol=1e-8):
    """PyTorch's autograd through `dopri5.replay_step` over the kernel's records: each step's state is the record's
    value plus the replay's zero-valued difference, so the values are the kernel's and the gradients the replay's."""
    x, leaves = _with_leaves(inp)
    params = {"expert": x["expert_params"]}
    if x["ml_w"] is not None:
        params["ml_net"] = [{"w": x["ml_w"], "b": x["ml_b"]}]
    ts = x["ts"]
    s = dopri5.Solve(roche_field, (params, DoseContext(times=x["times"][:, None], amounts=x["amounts"])),
                     ts.reshape(-1, 1, 1), ts[-1], dopri5._Tableau.make(torch.float32, ts.device),
                     dopri5._noise_floor(torch.float32, rtol), atol, None, True)
    y = x["y0"]
    loss = (g_out[0] * y).sum()
    for n in range(int(n_acc.max())):
        active = (n < n_acc)[:, None]
        t = torch.where(active, record[:, n, :1], ts[-1])
        h = torch.where(active, record[:, n, 1:2], 0.0)
        if n > 0:
            y = torch.where(active, record[:, n, 2:] + (y - y.detach()), y)
        y1, dense = dopri5.replay_step(s, t, y, h)
        t_new = torch.where(h == ts[-1] - t, ts[-1], t + h)
        fill = (s.ts_b > t) & (s.ts_b <= t_new) & active
        loss = loss + (g_out * torch.where(fill, dense, 0.0)).sum()
        y = torch.where(active, y1, y)
    return torch.autograd.grad(loss, leaves)


def _rel(got, want):
    return ((got.double() - want.double()).norm() / want.double().norm().clamp(min=1e-30)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [4, 6, 8, 12])
def test_the_recording_forward_is_the_no_grad_kernels_bit_for_bit(cohort, D):
    inp = _inputs(cohort, D, 2550)
    with torch.no_grad():
        want, want_st = roche_dopri5.roche_dopri5_per_row(**inp, max_steps=MAX_STEPS)
    got, got_st, _ = _kernel_grads(inp, _g_out(want.shape))
    _, rec_st, record = roche_dopri5.recorded_solve(**inp, max_steps=MAX_STEPS)
    assert record.shape == (2550, roche_dopri5.trial_budget(MAX_STEPS), D + 2)
    for st in (got_st, rec_st):
        for name in ("n_steps", "n_accepted", "success"):
            assert torch.equal(getattr(st, name), getattr(want_st, name)), name
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    # The record starts at t0 and y0, and the second accepted step where the first ended.
    acc = want_st.n_accepted
    assert torch.equal(record[:, 0, 2:][acc > 0], inp["y0"][acc > 0])
    assert bool((record[:, 0, 0][acc > 0] == 0).all())
    assert torch.equal(record[:, 1, 0][acc > 1], (record[:, 0, 0] + record[:, 0, 1])[acc > 1])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 50, 2550])
@pytest.mark.parametrize("D", [4, 6, 8, 12])
def test_gradients_match_autograd_through_replay_step_over_the_records(cohort, D, rows):
    """Rows that finish early, rows that spend the budget (every LATE_EVERY-th, from LATE_STATE) and the grid points
    they never reach: dy0, dW and db within GRAD_RTOL of the replay's autograd."""
    inp = _inputs(cohort, D, rows)
    _, st, record = roche_dopri5.recorded_solve(**inp, max_steps=MAX_STEPS)
    g_out = _g_out((T, rows, D))
    ys, st_grad, got = _kernel_grads(inp, g_out)
    assert torch.equal(st_grad.n_accepted, st.n_accepted)
    budget = roche_dopri5.trial_budget(MAX_STEPS)
    if rows >= LATE_EVERY:
        assert bool((st.n_steps == budget).any()) and bool((st.n_steps < budget).any())
        assert bool(torch.isnan(ys[-1]).any()) and bool(torch.isfinite(ys[-1]).any())
    want = _replay_grads(inp, record, st.n_accepted, g_out)
    assert len(got) == len(want) == (1 if D == 4 else 3)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel(g, w) <= GRAD_RTOL, (_rel(g, w), g.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [6, 12])
def test_gradients_are_as_accurate_as_the_plain_solvers_against_float64(cohort, D):
    """The loss sum(g_out * ys) of 50 rows that all finish: the kernel's gradients and the plain float32 solver's
    autograd, each against a float64 plain solve at rtol 1e-10."""
    inp = _inputs(cohort, D, 50, seed=2, late=False)
    g_out = _g_out((T, 50, D), seed=3)
    _, st, got = _kernel_grads(inp, g_out, max_steps=256)
    assert bool(st.success.all())

    def plain(dtype, **solve):
        x, leaves = _with_leaves(inp, dtype)
        ys, st = roche_dopri5.roche_dopri5_per_row_reference(**x, **solve)
        assert bool(st.success.all())
        return torch.autograd.grad(ys, leaves, g_out.to(dtype))

    f32 = plain(torch.float32, max_steps=256)
    f64 = plain(torch.float64, rtol=1e-10, atol=1e-12, max_steps=4096)
    for g, p, e in zip(got, f32, f64):
        assert _rel(g, e) <= ACCURACY * _rel(p, e) + GRAD_ATOL, (_rel(g, e), _rel(p, e))


def _fwd_bwd(inp, g_out):
    ys, st, grads = _kernel_grads(inp, g_out, max_steps=256)
    return (ys, st.n_steps, *grads)


@pytest.mark.cuda
def test_two_launches_agree_bit_for_bit(cohort):
    inp = _inputs(cohort, 6, 2550, seed=4)
    g_out = _g_out((T, 2550, 6))
    first, second = _fwd_bwd(inp, g_out), _fwd_bwd(inp, g_out)
    for a, b in zip(first, second):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


@pytest.mark.cuda
def test_a_captured_replay_equals_the_eager_call_and_fills_the_tally(cohort):
    """Forward and backward captured into one CUDA graph under `full_budget(tally)`: the replay's outputs and
    gradients are the eager call's bit for bit, and each replay adds the rows' trial steps to both counters."""
    inp = _inputs(cohort, 6, 50, seed=5)
    g_out = _g_out((T, 50, 6))
    x, leaves = _with_leaves(inp)
    eager = _fwd_bwd(inp, g_out)
    tally = torch.zeros(2, dtype=torch.int64, device="cuda")
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    launches = roche_dopri5.roche_dopri5_per_row_grad.launches
    with dopri5.full_budget(tally), torch.cuda.graph(graph, stream=stream):
        ys, st = roche_dopri5.roche_dopri5_per_row_grad(**x, max_steps=256)
        grads = torch.autograd.grad(ys, leaves, g_out)
    assert roche_dopri5.roche_dopri5_per_row_grad.launches == launches + 1
    torch.cuda.synchronize()
    assert tally.tolist() == [0, 0]  # the capture runs nothing
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(eager, (ys, st.n_steps, *grads)):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    n = int(st.n_steps.sum())
    assert tally.tolist() == [n, n]
    graph.replay()
    torch.cuda.synchronize()
    assert tally.tolist() == [2 * n, 2 * n]
    graph.reset()


def _worst_leaf_gap(got, want):
    """The benchmark's `grad` number: the worst leaf's gap of norms against the larger of its and the median leaf's
    reference norm."""
    norms = {n: float(w.double().norm()) for n, w in want.items()}
    median = statistics.median(norms.values())
    return max(abs(float(got[n].double().norm()) - v) / max(v, median, 1e-300) for n, v in norms.items())


@pytest.mark.cuda
def test_three_training_steps_on_the_route_stay_within_the_cells_limits(cohort, monkeypatch):
    """Three Adam steps of the sim cell's model (batch 50, per-patient DOPRI5 at its full budget, as the fused step
    runs it) on the route and on the plain route (`KERNEL_DEVICES` emptied), from the same weights, batches and
    noise: the worst step's loss and the first step's worst leaf gradient within the cell's `loss` and `grad`
    limits (`benchmark/limits/sim_hybrid.train.json`)."""
    with open(LIMITS) as f:
        limits = {k: v["limit"] for k, v in json.load(f).items()}
    data = SyntheticCohort.load(COHORT, device="cuda")
    data.set_train_size(1000)
    model = build_sim_model("hybrid", DataConfig(), max_steps=256)
    gen = torch.Generator().manual_seed(6)
    init = init_vi(gen, model, device="cuda")
    noise = [elbo.draw_noise(model, 50, gen, "cuda") for _ in range(3)]
    batches = [data.get_split("train", 50, i) for i in range(3)]

    def run():
        params = copy.deepcopy(init)
        names = [n for n, p in params.named_parameters() if p.requires_grad]
        leaves = [p for p in params.parameters() if p.requires_grad]
        opt = torch.optim.Adam(leaves, lr=0.01)
        losses, first = [], None
        for batch, (eps, eps_kl) in zip(batches, noise):
            with dopri5.full_budget():
                loss = elbo.sim_loss(params, model, batch, eps=eps, eps_kl=eps_kl)
                grads = torch.autograd.grad(loss, leaves)
            losses.append(loss.item())
            first = first or dict(zip(names, grads))
            for p, g in zip(leaves, grads):
                p.grad = g
            opt.step()
        return losses, first

    launches = roche_dopri5.roche_dopri5_per_row_grad.launches
    got_losses, got_grads = run()
    assert roche_dopri5.roche_dopri5_per_row_grad.launches == launches + 3
    monkeypatch.setattr(decoders, "KERNEL_DEVICES", ())
    want_losses, want_grads = run()
    assert roche_dopri5.roche_dopri5_per_row_grad.launches == launches + 3
    assert all(np.isfinite(got_losses)) and all(np.isfinite(want_losses))
    loss_gap = max(abs(g - w) / abs(w) for g, w in zip(got_losses, want_losses))
    assert loss_gap <= limits["loss"], loss_gap
    assert _worst_leaf_gap(got_grads, want_grads) <= limits["grad"]
