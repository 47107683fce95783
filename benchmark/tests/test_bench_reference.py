"""The plain reference agrees with itself across its own paths, at a tiny size."""

import json
import math
import os

import numpy as np
import torch

from benchmark.harness import weights
from benchmark.harness.spec import BENCH_DIR, ROOT
from benchmark.reference import cohort, model, real, scores, sim, solvers

SIM = json.load(open(os.path.join(BENCH_DIR, "configs", "lhm_sim_hybrid.json")))
REAL = json.load(open(os.path.join(BENCH_DIR, "configs", "lhm_real_hybrid.json")))
CPU = torch.device("cpu")


def _f64(cfg, seed=5):
    return {k: v.double() for k, v in weights.make(cfg, seed, CPU).items()}


def test_dopri5_rows_solves_each_row_on_its_own():
    rates = torch.tensor([[0.5], [-1.0], [2.0]], dtype=torch.float64)
    ts = torch.linspace(0, 2, 5, dtype=torch.float64)
    ys, trials = solvers.dopri5_rows(lambda t, y: rates * y, torch.ones(3, 1, dtype=torch.float64), ts, 1e-9, 1e-12)
    assert torch.allclose(ys[..., 0], torch.exp(rates[:, 0] * ts[:, None]), rtol=1e-7)
    assert trials[2] > trials[0]  # the fastest row needs the most steps; the others do not take them


def test_sim_decode_dopri5_agrees_with_rk4_at_a_fine_step():
    p = _f64(SIM)
    test = cohort.load(dict(SIM, cohort=dict(SIM["cohort"], test=8)), ROOT)["test"]
    a = torch.zeros_like(torch.as_tensor(test["actions"], dtype=torch.float64))  # no dose: no jump in the field
    mu, _ = sim.encode(p, torch.as_tensor(test["measurements"]).double(), a,
                             torch.as_tensor(test["masks"]).double())
    x_dp, _ = sim.decode(SIM, p, mu, a, {"ode_method": "dopri5"})
    x_rk, _ = sim.decode(SIM, p, mu, a, {"ode_method": "rk4", "ode_step_size": 1 / 64})
    assert torch.allclose(x_dp, x_rk, rtol=1e-6, atol=1e-7)


def test_real_adams_agrees_with_rk4_at_a_fine_step():
    p = _f64(REAL)
    field = real.field(p, torch.zeros(97, 4, 1, dtype=torch.float64), 4)
    y0 = torch.linspace(-0.5, 0.5, 80, dtype=torch.float64).reshape(4, 20)
    ts = torch.arange(23.0, 30.0, dtype=torch.float64)
    ab = solvers.adams_bashforth4(field, y0, ts, 64)
    rk = solvers.rk4(field, y0, ts, 64)
    assert torch.allclose(ab, rk, rtol=1e-6, atol=1e-8)


def test_crps_pairwise_equals_the_sorted_estimator():
    g = torch.Generator().manual_seed(0)
    samples, truth = torch.randn(3, 4, 7, generator=g, dtype=torch.float64), torch.randn(3, 4, generator=g,
                                                                                       dtype=torch.float64)
    m = samples.shape[-1]
    coef = (2.0 * torch.arange(m, dtype=torch.float64) + 1.0 - m) / (m * m)
    sorted_form = (samples - truth[..., None]).abs().mean(-1) - (coef * samples.sort(-1).values).sum(-1)
    assert torch.allclose(scores.crps(truth, samples), sorted_form)


def test_train_steps_repeat_and_the_gradient_matches_a_finite_difference():
    p = _f64(REAL)
    folds = cohort.load(dict(REAL, cohort=dict(REAL["cohort"], train=6, val=4, test=4)), ROOT)
    batch = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in folds["train"].items()}
    val = [{k: torch.as_tensor(v, dtype=torch.float64) for k, v in folds["val"].items()}]
    mix = {"lr": 0.01, "val_criterion": "elbo"}
    a = model.train_steps(REAL, mix, p, [batch], [None], val)
    b = model.train_steps(REAL, mix, p, [batch], [None], val)
    assert a["losses"] == b["losses"] and a["val"] == b["val"]
    name, h = "decoder.ode.kel", 1e-6
    up, down = dict(p), dict(p)
    up[name], down[name] = p[name] + h, p[name] - h
    fd = (real.masked_error(REAL, up, batch) - real.masked_error(REAL, down, batch)) / (2 * h)
    assert math.isclose(float(a["first_grads"][name]), float(fd), rel_tol=1e-5)


def test_bootstrap_draws_as_numpy_global_generator():
    err = np.arange(1.0, 11.0)
    np.random.seed(12)
    idx = np.random.randint(0, 10, size=(scores.N_BOOT, 10))
    want = float(np.std(np.sqrt(np.mean(err[idx], axis=1))))
    assert scores.bootstrap_se(err, np.random.RandomState(12)) == want
