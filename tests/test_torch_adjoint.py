"""Port vs JAX: the adjoint DOPRI5 solver, trial-budget calibration and the lockstep CLI.

`odeint_dopri5_adjoint` records the accepted steps of a solve made without
gradient and replays them in reverse. What must hold:

* Values: its forward is the port's `odeint_dopri5`, bit for bit, with the
  same step counts, lockstep and per row, float32 and float64.
* Gradients against `jax.grad` of JAX's `odeint_dopri5_adjoint` in float64,
  where both packages take the same steps: rtol 1e-6 (the nonlinear field of
  tests/test_solvers.py, its per-patient `vmap` as `per_row=True`, the
  barrier case of tests/test_utils.py).
* Gradients against backprop through the port's own `odeint_dopri5` in
  float32, on the Roche decoder (B=3, latent 6), lockstep and per sample:
  rtol 2e-3, atol 1e-5, the tolerance of tests/test_models.py. No JAX Roche
  solve runs under `jax.grad` here: it compiles for minutes.
* `recorded_all`, the overflow warning and budget exhaustion as JAX's.

`calibrate_trial_budget` returns JAX's budget in float64. The lockstep CLI
trains on a small JAX-generated cohort; its curve is within 1e-4 of the same
run with backprop through the lockstep solve.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridode.config import RocheConfig as JRocheConfig
from hybridode.data import SyntheticCohort as JSyntheticCohort
from hybridode.fields import DoseContext as JDoseContext
from hybridode.fields import init_roche_field as j_init_roche_field
from hybridode.fields import roche_field as j_roche_field
from hybridode.solvers import calibrate_trial_budget as j_calibrate_trial_budget
from hybridode.solvers import odeint_dopri5_adjoint as j_odeint_dopri5_adjoint
from hybridode_torch.cli import common, run_simulation
from hybridode_torch.config import DataConfig, EvalConfig, OptimConfig
from hybridode_torch.convert import params_from_jax
from hybridode_torch.data import SyntheticCohort
from hybridode_torch.fields import DoseContext, doses_from_actions, init_roche_field, roche_field
from hybridode_torch.models.decoders import SimDecoderSpec, init_sim_decoder, sim_decoder_apply
from hybridode_torch.solvers import calibrate_trial_budget, odeint_dopri5, odeint_dopri5_adjoint

COHORT = os.path.join(os.path.dirname(__file__), os.pardir, "data_s123", "datafile_dose_exp.pkl")
TS = np.linspace(0.0, 5.0, 11)
RTOL64 = 1e-6


def exp_decay(t, y, k):
    return -k * y


def j_exp_decay(t, y, k):
    return -k * y


def oscillator(t, y, w):
    return torch.stack([y[..., 1], -(w**2) * y[..., 0]], dim=-1)


def j_oscillator(t, y, w):
    return jnp.stack([y[..., 1], -(w**2) * y[..., 0]], axis=-1)


def _leaf(x, dtype=torch.float64):
    return torch.tensor(x, dtype=dtype, requires_grad=True)


# --- values --------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("per_row", [False, True], ids=["lockstep", "per_row"])
def test_forward_is_odeint_dopri5_bit_for_bit(per_row, dtype):
    """8 patients of data_s123 (their doses), the field's random init, the CLI's rtol; gradients recorded."""
    c = SyntheticCohort.load(COHORT, device="cpu")
    ctx = doses_from_actions(c.get_split("train", 8, 0)["actions"].to(dtype), 1.0)
    gen = torch.Generator().manual_seed(0)
    params = init_roche_field(gen, 6, device="cpu").to(dtype=dtype)
    y0 = (torch.exp(0.3 * torch.randn(8, 6, generator=gen)) / 10).to(dtype).requires_grad_()
    ts = torch.arange(15, dtype=dtype)
    kw = dict(rtol=1e-7, atol=1e-8, max_steps=512, per_row=per_row)
    ys, st = odeint_dopri5_adjoint(roche_field, y0, ts, (params, ctx), **kw)
    want, st_want = odeint_dopri5(roche_field, y0, ts, (params, ctx), **kw)
    assert ys.requires_grad and torch.equal(ys.detach(), want.detach())
    assert torch.equal(st.n_accepted, st_want.n_accepted) and torch.equal(st.n_steps, st_want.n_steps)
    assert bool(st.success.all()) and bool(st.recorded_all.all())
    with torch.no_grad():  # the path that records nothing: the same values and stats
        ys0, st0 = odeint_dopri5_adjoint(roche_field, y0, ts, (params, ctx), **kw)
    assert torch.equal(ys0, want.detach()) and all(torch.equal(a, b) for a, b in zip(st0, st))


# --- gradients against JAX (float64) ----------------------------------------------


def test_grads_of_a_nonlinear_field_match_jax():
    """dy/dt = -lam y + w sin(t) y^2 with y0 and both arguments differentiated, mid-grid outputs."""
    ts = np.linspace(0.0, 3.0, 7)
    y0 = np.array([[0.3, 0.8]])

    def loss_of(ys):
        return (ys[1:] ** 2).sum() + (ys[3] * 0.5).sum()

    with jax.enable_x64(True):
        def j_field(t, y, a):
            return -a[0] * y + a[1] * jnp.sin(t) * y**2

        def j_loss(y0, a):
            ys, _ = j_odeint_dopri5_adjoint(j_field, y0, jnp.asarray(ts), a, rtol=1e-8, atol=1e-10, max_steps=512)
            return loss_of(ys)

        want = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(y0), (jnp.float64(0.9), jnp.float64(0.2)))

    y, lam, w = _leaf(y0), _leaf(0.9), _leaf(0.2)
    ys, st = odeint_dopri5_adjoint(lambda t, y, a: -a[0] * y + a[1] * torch.sin(t) * y**2, y,
                                   torch.tensor(ts), (lam, w), rtol=1e-8, atol=1e-10, max_steps=512)
    loss_of(ys).backward()
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(want[0]), rtol=RTOL64)
    np.testing.assert_allclose([lam.grad.item(), w.grad.item()], [float(want[1][0]), float(want[1][1])], rtol=RTOL64)


def test_per_row_grads_match_jax_vmap():
    """JAX vmaps one adjoint solve per patient; the port solves the rows at once, each with its own controller.
    The rows accept 9, 14 and 19 steps, so the backward's slots hold 3, then 2, then 1 rows."""
    y0 = np.array([[1.0, 2.0], [3.0, 0.5], [0.2, 0.9]])
    lam = np.array([0.5, 0.9, 1.3])
    ts = np.linspace(0.0, 2.0, 5)

    with jax.enable_x64(True):
        def j_loss(y0, lam):
            def one(y, k):
                ys, st = j_odeint_dopri5_adjoint(j_exp_decay, y, jnp.asarray(ts), k, rtol=1e-7, atol=1e-9)
                return ys, st.n_accepted

            ys, n_acc = jax.vmap(one, out_axes=(1, 0))(y0, lam)
            return jnp.sum(ys[-1]) + jnp.sum(ys**2), n_acc

        (_, j_acc), want = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(y0), jnp.asarray(lam))

    y, k = _leaf(y0), _leaf(lam[:, None])
    ys, st = odeint_dopri5_adjoint(exp_decay, y, torch.tensor(ts), k, rtol=1e-7, atol=1e-9, per_row=True)
    (ys[-1].sum() + (ys**2).sum()).backward()
    assert st.n_accepted.tolist() == np.asarray(j_acc).tolist() == [9, 14, 19]
    np.testing.assert_allclose(y.grad.numpy(), np.asarray(want[0]), rtol=RTOL64)
    np.testing.assert_allclose(k.grad.numpy()[:, 0], np.asarray(want[1]), rtol=RTOL64)


def test_barrier_grads_match_jax():
    """A forcing with a kink at t=2 and a barrier there, as tests/test_utils.py holds JAX's adjoint."""
    ts = np.linspace(0.0, 4.0, 9)
    y0 = np.array([[1.0, 2.0]])

    with jax.enable_x64(True):
        def j_loss(lam):
            ys, _ = j_odeint_dopri5_adjoint(lambda t, y, k: -k * y + jnp.where(t >= 2.0, 0.5, 0.0), jnp.asarray(y0),
                                            jnp.asarray(ts), lam, rtol=1e-7, atol=1e-9, barriers=(2.0,))
            return jnp.sum(ys**2)

        j_value, j_grad = jax.value_and_grad(j_loss)(jnp.float64(0.8))

    lam = _leaf(0.8)
    ys, _ = odeint_dopri5_adjoint(lambda t, y, k: -k * y + torch.where(t >= 2.0, 0.5, 0.0), torch.tensor(y0),
                                  torch.tensor(ts), lam, rtol=1e-7, atol=1e-9, barriers=(2.0,))
    loss = (ys**2).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_value), rtol=1e-12)
    np.testing.assert_allclose(lam.grad.item(), float(j_grad), rtol=RTOL64)


def test_grad_analytic():
    lam = _leaf(0.5, torch.float32)
    ys, _ = odeint_dopri5_adjoint(exp_decay, torch.ones(1, 1), torch.tensor([0.0, 2.0]), lam, rtol=1e-9, atol=1e-11)
    ys[-1, 0, 0].backward()
    np.testing.assert_allclose(lam.grad.item(), -2.0 * np.exp(-1.0), rtol=1e-4)


def test_grad_wrt_y0_includes_identity_term():
    y0 = torch.tensor([[1.0, 2.0]], requires_grad=True)
    ys, _ = odeint_dopri5_adjoint(exp_decay, y0, torch.tensor([0.0, 1.0]), 1.0)
    ((ys[0] ** 2).sum() + (ys[-1] ** 2).sum()).backward()
    np.testing.assert_allclose(y0.grad.numpy(), (2 * y0 + 2 * y0 * np.exp(-2.0)).detach().numpy(), rtol=1e-4)


# --- gradients against the port's backprop (float32, Roche decoder) ----------------


@pytest.mark.parametrize("per_sample", [False, True], ids=["lockstep", "per_sample"])
def test_sim_decoder_adjoint_matches_backprop(per_sample):
    """B=3, latent 6, a dose of 0.5 at t=3 (tests/test_models.py's case), the field's random init."""
    B, obs, latent = 3, 8, 6
    base = dict(obs_dim=obs, latent_dim=latent, action_dim=1, t_max=14, step_size=1, roche=True,
                max_steps=256 if per_sample else 512, per_sample_control=per_sample)
    spec_bp = SimDecoderSpec(**base, use_adjoint=False)
    spec_adj = SimDecoderSpec(**base, use_adjoint=True, max_record=None if per_sample else 256)
    gen = torch.Generator().manual_seed(0)
    params = init_sim_decoder(gen, spec_bp, device="cpu")
    init = (torch.randn(B, latent, generator=gen).abs() * 0.01).requires_grad_()
    actions = torch.zeros(15, B, 1)
    actions[3, :, 0] = 0.5

    def grads(spec):
        params.zero_grad(set_to_none=True)
        init.grad = None
        x, _ = sim_decoder_apply(params, spec, init, actions)
        (x**2).sum().backward()
        return x.detach(), {n: p.grad for n, p in params.named_parameters()}, init.grad

    x_bp, g_bp, gi_bp = grads(spec_bp)
    x_adj, g_adj, gi_adj = grads(spec_adj)
    np.testing.assert_allclose(x_adj.numpy(), x_bp.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gi_adj.numpy(), gi_bp.numpy(), rtol=2e-3, atol=1e-5)
    assert [n for n, g in g_adj.items() if g is None] == [n for n, g in g_bp.items() if g is None]
    for name, g in g_bp.items():
        if g is not None:
            np.testing.assert_allclose(g_adj[name].numpy(), g.numpy(), rtol=2e-3, atol=1e-5, err_msg=name)


def test_frozen_expert_leaves_get_no_gradient():
    gen = torch.Generator().manual_seed(0)
    params = init_roche_field(gen, 6, device="cpu")
    ctx = DoseContext(times=torch.tensor([[3.0], [5.0]]), amounts=torch.tensor([1.0, 2.0]))
    ys, _ = odeint_dopri5_adjoint(roche_field, torch.full((2, 6), 0.05), torch.arange(15.0), (params, ctx))
    ys.sum().backward()
    frozen = {n: p.grad for n, p in params.named_parameters() if not p.requires_grad}
    assert len(frozen) == 13 and all(g is None for g in frozen.values())
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in params.parameters() if p.requires_grad)


# --- record overflow and budget exhaustion ------------------------------------------


@pytest.mark.parametrize("per_row", [False, True], ids=["lockstep", "per_row"])
def test_max_record_overflow_flagged(per_row):
    """With fewer record slots than accepted steps: recorded_all False, the true n_accepted, success True;
    per row, exactly the rows that overflow (JAX's vmap as reference)."""
    y0 = np.array([[1.0, 2.0], [3.0, 0.5], [0.2, 0.9]])
    lam = np.array([0.5, 0.9, 1.3])
    with jax.enable_x64(True):
        def one(y, k):
            return j_odeint_dopri5_adjoint(j_exp_decay, y, jnp.asarray(TS), k, rtol=1e-7, atol=1e-9, max_record=12)[1]

        j_st = jax.vmap(one)(jnp.asarray(y0), jnp.asarray(lam)) if per_row else one(jnp.asarray(y0), 0.7)
    k = torch.tensor(lam[:, None]) if per_row else 0.7
    kw = dict(rtol=1e-7, atol=1e-9, per_row=per_row)
    _, full = odeint_dopri5(exp_decay, torch.tensor(y0), torch.tensor(TS), k, **kw)
    assert full.recorded_all is True  # the bounded-scan integrator differentiates every step
    y = torch.tensor(y0, requires_grad=True)
    _, st = odeint_dopri5_adjoint(exp_decay, y, torch.tensor(TS), k, max_record=12, **kw)
    assert np.asarray(st.recorded_all).tolist() == np.asarray(j_st.recorded_all).tolist()
    assert not bool(st.recorded_all.all()) and torch.equal(st.n_accepted, full.n_accepted)
    assert np.asarray(st.n_accepted).tolist() == np.asarray(j_st.n_accepted).tolist()
    assert bool(st.success.all())
    _, ok = odeint_dopri5_adjoint(exp_decay, y, torch.tensor(TS), k, max_record=int(full.n_accepted.max()), **kw)
    assert bool(ok.recorded_all.all())


def test_max_record_overflow_warns():
    y0 = torch.tensor([[1.0, 2.0]], requires_grad=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ys, _ = odeint_dopri5_adjoint(exp_decay, y0, torch.tensor(TS), 0.7, rtol=1e-7, atol=1e-9, max_steps=64,
                                      max_record=3)
        (ys**2).sum().backward()
    assert any(issubclass(w.category, RuntimeWarning) and "max_record" in str(w.message) for w in caught)
    # Safe sizing (max_record defaults to max_steps): no warning at all.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ys, _ = odeint_dopri5_adjoint(exp_decay, y0, torch.tensor(TS), 0.7, rtol=1e-7, atol=1e-9, max_steps=64)
        (ys**2).sum().backward()
    assert not any("max_record" in str(w.message) for w in caught)


def test_max_steps_exhaustion_yields_nan():
    """JAX's while loop stops at exactly max_steps trial steps; so does the port's adjoint."""
    ts = np.linspace(0.0, 100.0, 5)
    _, j_st = j_odeint_dopri5_adjoint(j_oscillator, jnp.ones((2, 2)), jnp.asarray(ts, jnp.float32), 50.0,
                                      rtol=1e-12, atol=1e-14, max_steps=4)
    y0 = torch.ones(2, 2, requires_grad=True)
    ys, st = odeint_dopri5_adjoint(oscillator, y0, torch.tensor(ts, dtype=torch.float32), 50.0, rtol=1e-12,
                                   atol=1e-14, max_steps=4)
    assert not bool(st.success) and bool(torch.isnan(ys[-1]).any())
    assert int(st.n_steps) == int(j_st.n_steps) == 4


# --- trial-budget calibration ---------------------------------------------------------


def test_calibrated_budget_equals_jax_on_exp_decay_lanes():
    """Eight lanes of stiffness 0.2..3 (tests/test_solvers.py); the port's per-row rates come as (B, 1)."""
    y0 = np.linspace(0.5, 2.0, 8)[:, None]
    ks = np.linspace(0.2, 3.0, 8)
    ts = np.linspace(0.0, 5.0, 11)
    for per_sample in (True, False):
        with jax.enable_x64(True):
            want = j_calibrate_trial_budget(j_exp_decay, jnp.asarray(y0), jnp.asarray(ts),
                                            jnp.asarray(ks) if per_sample else 1.3, rtol=1e-6, atol=1e-9,
                                            per_sample=per_sample)
        got = calibrate_trial_budget(exp_decay, torch.tensor(y0), torch.tensor(ts),
                                     torch.tensor(ks[:, None]) if per_sample else 1.3, rtol=1e-6, atol=1e-9,
                                     per_sample=per_sample)
        assert got == want and got % 64 == 0
    _, st = odeint_dopri5(exp_decay, torch.tensor(y0), torch.tensor(ts), torch.tensor(ks[:, None]), rtol=1e-6,
                          atol=1e-9, max_steps=got, per_row=True)
    assert bool(st.success.all())


def test_flat_per_row_argument_is_refused():
    """A (B,) rate against the (B, 1) state broadcasts to (B, B): refused, not solved."""
    with pytest.raises(ValueError, match="per-row arguments"):
        calibrate_trial_budget(exp_decay, torch.ones(8, 1), torch.linspace(0.0, 5.0, 11), torch.linspace(0.2, 3.0, 8))


def test_calibrated_budget_equals_jax_on_a_roche_batch():
    """16 patients of data_s123 (their doses), the field's random init, the CLI's rtol, float64."""
    B = 16
    jc = JSyntheticCohort.load(COHORT)
    rng = np.random.RandomState(0)
    y0 = np.exp(0.3 * rng.randn(B, 6)) / 10
    jparams = j_init_roche_field(jax.random.PRNGKey(0), 6)
    times = np.asarray(jc.dose_time[:B], np.float64)
    amounts = np.asarray(jc.dose_amount[:B], np.float64)
    with jax.enable_x64(True):
        jp64 = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(jnp.asarray(x, jnp.float64), (B,) + x.shape),
                                      jparams)
        want = j_calibrate_trial_budget(j_roche_field, jnp.asarray(y0), jnp.arange(15.0),
                                        (jp64, JDoseContext(jnp.asarray(times), jnp.asarray(amounts))))
    params = params_from_jax(jparams, device="cpu").to(torch.float64)
    ctx = DoseContext(times=torch.tensor(times), amounts=torch.tensor(amounts))
    got = calibrate_trial_budget(roche_field, torch.tensor(y0), torch.arange(15.0, dtype=torch.float64),
                                 (params, ctx))
    assert got == want


def test_probe_exhaustion_raises():
    with pytest.raises(RuntimeError, match="probe"):
        calibrate_trial_budget(exp_decay, torch.ones(2, 1), torch.linspace(0.0, 5.0, 11),
                               torch.tensor([[1.0], [400.0]]), rtol=1e-9, atol=1e-12, probe_budget=64)


# --- the lockstep CLI ------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    """32 patients (16 train, 8 val, 8 test), obs 8, latent 6, generated by the JAX package."""
    dg = JSyntheticCohort(n_sample=32, obs_dim=8, t_max=14, step_size=1, roche_config=JRocheConfig(kel=1),
                          output_sigma=0.2, dose_max=10, latent_dim=6, sparsity=0.5, output_sparsity=0.5,
                          p_remove=0.5, val_size=8, test_size=8, rng=np.random.RandomState(7))
    dg.generate_data()
    dg.split_sample()
    path = str(tmp_path_factory.mktemp("data") / "cohort.pkl")
    dg.save(path)
    return path


def test_run_simulation_lockstep_trains_like_backprop(small_data, tmp_path, monkeypatch, capsys):
    """Two iterations, validation after each: the adjoint run's curve within 1e-4 of the same run that
    backpropagates through the lockstep solve (use_adjoint=False, the same spec otherwise)."""
    dc = DataConfig(obs_dim=8, latent_dim=6)
    optim = OptimConfig(shuffle=False, n_restart=1, batch_size=8, niters=2, test_freq=1, early_stop=10)

    def run(name):
        curve = str(tmp_path / f"{name}.csv")
        _, model, scores = run_simulation.run(seed=3, elbo=True, eval_only=False, init_path=None,
                                              data_path=small_data, sample=24, data_config=dc, model_method="hybrid",
                                              path=str(tmp_path / name) + "_", optim_config=optim,
                                              eval_config=EvalConfig(t0=5), curve_path=curve, lockstep=True,
                                              device="cpu")
        return model, np.loadtxt(curve, delimiter=",", ndmin=2), scores

    model, curve, scores = run("adjoint")
    spec = model.decoder_spec
    assert (spec.use_adjoint, spec.per_sample_control, spec.max_steps, spec.max_record) == (True, False, 4096, 1024)
    assert "Training with 24 samples" in capsys.readouterr().out

    build = common.build_sim_model
    monkeypatch.setattr(common, "build_sim_model", lambda *a, **k: (lambda m: m._replace(
        decoder_spec=m.decoder_spec._replace(use_adjoint=False)))(build(*a, **k)))
    _, curve_bp, scores_bp = run("backprop")
    assert curve.shape == (2, 3) and np.all(np.isfinite(curve)) and np.all(np.isfinite(scores))
    np.testing.assert_allclose(curve, curve_bp, rtol=1e-4)
