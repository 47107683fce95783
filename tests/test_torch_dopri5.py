"""Port vs JAX: adaptive DOPRI5, lockstep and per-row, on the Roche field with real dose schedules.

Eight patients of data_s123's training fold (their dose times and amounts),
initial states in the encoder's range, the field's random initialisation,
the CLI's budget max_steps=256 (512 in lockstep, where one controller serves
the batch), rtol=1e-7, atol=1e-8. The JAX reference of per-row control is
`jax.vmap` of one `odeint_dopri5` per patient, as the sim decoder runs it.

Two precisions, because the step sequence is exact only in one of them:

* float64 (JAX under `jax.enable_x64`): the error estimate is far above
  rounding, so both packages take the same steps. Step counts are equal on
  every row and trajectories agree to rtol 1e-7, atol 1e-9.
* float32, the precision the model trains in: at rtol=1e-7 the embedded
  error estimate sits at rounding level (the noise floor of `_error_norm`
  exists for that reason), and the two packages round differently: XLA on
  the CPU fuses every `a * b + c` into one FMA and has its own tanh and exp,
  PyTorch rounds each operation. So accept decisions flip, and per-row trial
  counts differ by up to a quarter (`dopri5_parity_study.py` at the root
  measures all of this on 32 patients). What must hold is accuracy: each
  solve is held against a float64 solve at rtol=1e-12, from which JAX's
  float32 solve is ~1e-5 away, so the port's may be off by at most twice
  JAX's; port and JAX agree to rtol 1e-4, atol 2e-5 (the sum of the two
  errors); and the step counts summed over the batch stay within 5 %
  (per-row) or 10 % (one lockstep solve) of JAX's.

Gradients (float32) are held to |g_port - g_jax| <= 2e-3 max|g_jax| + 1e-6 per leaf.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridode.data import SyntheticCohort as JSyntheticCohort
from hybridode.fields import DoseContext as JDoseContext
from hybridode.fields import doses_from_actions as j_doses_from_actions
from hybridode.fields import init_neural_field as j_init_neural_field
from hybridode.fields import init_roche_field as j_init_roche_field
from hybridode.fields import neural_field as j_neural_field
from hybridode.fields import roche_field as j_roche_field
from hybridode.solvers import odeint_dopri5 as j_odeint_dopri5
from hybridode_torch.convert import params_from_jax
from hybridode_torch.fields import DoseContext, exp_decay_dose, impulse_dose, neural_field, roche_field
from hybridode_torch.solvers import odeint_dopri5

COHORT = os.path.join(os.path.dirname(__file__), os.pardir, "data_s123", "datafile_dose_exp.pkl")
B, D = 8, 6
TS = np.arange(15, dtype=np.float32)
RTOL32, ATOL32 = 1e-4, 2e-5
RTOL64, ATOL64 = 1e-7, 1e-9


@pytest.fixture(scope="module")
def case():
    """JAX field params, y0 (B, D), dose times (B, 1) and amounts (B,) of 8 cohort patients."""
    jc = JSyntheticCohort.load(COHORT)
    ctx = j_doses_from_actions(jc.get_split("train", B, 0)["actions"], 1.0)
    rng = np.random.RandomState(0)
    y0 = (np.exp(0.3 * rng.randn(B, D)) / 10).astype(np.float32)
    return j_init_roche_field(jax.random.PRNGKey(0), D), y0, np.array(ctx.times), np.array(ctx.amounts)


def _jax_solve(jparams, y0, times, amounts, per_row, dtype=jnp.float32, field=j_roche_field, **kw):
    """-> (ys, n_accepted, n_steps, success) as numpy, JAX's per-row reference being vmap over patients."""
    cast = lambda a: jnp.asarray(np.asarray(a), dtype)  # noqa: E731
    jparams = jax.tree_util.tree_map(cast, jparams)
    ts = cast(TS)
    if per_row:
        def one(z, t, a):
            return j_odeint_dopri5(field, z, ts, (jparams, JDoseContext(t, a)), **kw)

        ys, st = jax.jit(jax.vmap(one, out_axes=(1, 0)))(cast(y0), cast(times), cast(amounts))
    else:
        ys, st = jax.jit(lambda z: j_odeint_dopri5(field, z, ts, (jparams, JDoseContext(cast(times), cast(amounts))),
                                                   **kw))(cast(y0))
    return tuple(np.asarray(a) for a in (ys, st.n_accepted, st.n_steps, st.success))


def _port_solve(jparams, y0, times, amounts, per_row, dtype=torch.float32, field=roche_field, **kw):
    params = params_from_jax(jparams, device="cpu").to(dtype)
    cast = lambda a: torch.as_tensor(np.asarray(a)).to(dtype)  # noqa: E731
    with torch.no_grad():
        ys, st = odeint_dopri5(field, cast(y0), cast(TS), (params, DoseContext(cast(times), cast(amounts))),
                               per_row=per_row, **kw)
    return ys.numpy(), st.n_accepted.numpy(), st.n_steps.numpy(), st.success.numpy()


def _budget(per_row):
    return 256 if per_row else 512


def _assert_close64(got, want, times):
    """float64 trajectories, tight except on the jump of each patient's own dose.

    The Dose2 state at a grid point that is the patient's dose time sits on the
    jump of its forcing: the value there depends on which side of the jump
    rounding puts a stage, so there even JAX's own jitted and eager runs of
    one lockstep solve disagree beyond the tight tolerance.
    """
    at_jump = np.zeros(got.shape, bool)
    at_jump[:, :, 3] = TS[:, None] == times[None, :, 0]
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    tight, loose = finite & ~at_jump, finite & at_jump
    np.testing.assert_allclose(got[tight], want[tight], rtol=RTOL64, atol=ATOL64)
    np.testing.assert_allclose(got[loose], want[loose], rtol=0, atol=5e-7)


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "lockstep"])
def test_dopri5_float64_takes_the_same_steps_as_jax(case, per_row):
    jparams, y0, times, amounts = case
    with jax.enable_x64(True):
        want = _jax_solve(jparams, y0, times, amounts, per_row, jnp.float64, max_steps=_budget(per_row))
    got = _port_solve(jparams, y0, times, amounts, per_row, torch.float64, max_steps=_budget(per_row))
    assert want[0].dtype == np.float64 and np.all(want[3]) and np.all(got[3])
    assert got[0].shape == (len(TS), B, D) and np.isfinite(got[0]).all()
    np.testing.assert_array_equal(got[1], want[1])  # accepted steps, per row
    np.testing.assert_array_equal(got[2], want[2])  # trial steps, per row
    _assert_close64(got[0], want[0], times)


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "lockstep"])
def test_dopri5_float32_matches_jax_within_its_accuracy(case, per_row):
    jparams, y0, times, amounts = case
    ms = _budget(per_row)
    want = _jax_solve(jparams, y0, times, amounts, per_row, max_steps=ms)
    got = _port_solve(jparams, y0, times, amounts, per_row, max_steps=ms)
    truth = _port_solve(jparams, y0, times, amounts, True, torch.float64, max_steps=20000, rtol=1e-12, atol=1e-14)[0]
    assert np.all(want[3]) and np.all(got[3]) and np.isfinite(got[0]).all()
    err_jax, err_port = np.max(np.abs(want[0] - truth)), np.max(np.abs(got[0] - truth))
    assert err_port <= 2.0 * err_jax, (err_port, err_jax)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL32, atol=ATOL32)
    band = 0.05 if per_row else 0.10
    for g, w in ((got[1], want[1]), (got[2], want[2])):
        assert got[1].shape == ((B,) if per_row else ())
        assert abs(int(g.sum()) - int(w.sum())) <= band * int(w.sum()), (g, w)


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "lockstep"])
def test_dopri5_budget_exhaustion_gives_nan_and_failure(case, per_row):
    """max_steps=64 cannot reach t=14: unreached grid points are NaN and success is False, in both packages."""
    jparams, y0, times, amounts = case
    with jax.enable_x64(True):
        want = _jax_solve(jparams, y0, times, amounts, per_row, jnp.float64, max_steps=64)
    got = _port_solve(jparams, y0, times, amounts, per_row, torch.float64, max_steps=64)
    assert not np.any(want[3]) and not np.any(got[3])
    np.testing.assert_array_equal(np.isnan(got[0]), np.isnan(want[0]))
    assert np.isnan(got[0][-1]).all() and np.isfinite(got[0][:2]).all()
    # Within each row, the reached grid points come first and the NaNs after them.
    reached = np.isfinite(got[0]).all(axis=-1)  # (T, B) or (T,) in lockstep... always (T, B) here
    assert np.all(np.diff(reached.astype(int), axis=0) <= 0)
    np.testing.assert_array_equal(got[2], want[2])
    _assert_close64(got[0], want[0], times)


@pytest.mark.parametrize("per_row", [True, False], ids=["per_row", "lockstep"])
def test_dopri5_barriers_match_jax(case, per_row):
    """Steps clipped at the integer dose grid (float64, so the step sequences are exact)."""
    jparams, y0, times, amounts = case
    barriers = np.arange(1.0, 14.0)
    kw = dict(max_steps=256 if per_row else 1024, barriers=barriers)
    with jax.enable_x64(True):
        want = _jax_solve(jparams, y0, times, amounts, per_row, jnp.float64, **kw)
    got = _port_solve(jparams, y0, times, amounts, per_row, torch.float64, **kw)
    plain = _port_solve(jparams, y0, times, amounts, per_row, torch.float64, max_steps=kw["max_steps"])
    assert np.all(got[3]) and np.all(want[3])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert np.all(got[1] >= len(barriers) + 1)  # at least one step between two barriers
    assert not np.array_equal(got[2], plain[2])  # the barriers changed the step sequence
    _assert_close64(got[0], want[0], times)


def test_dopri5_float32_gradients_match_jax(case):
    """d/dy0 and d/d(ml_net) of a weighted sum of the per-row trajectory."""
    jparams, y0, times, amounts = case
    w = np.random.RandomState(1).randn(len(TS), B, D).astype(np.float32)

    def j_loss(z, ml):
        p = dict(jparams, ml_net=ml)

        def one(zi, t, a):
            return j_odeint_dopri5(j_roche_field, zi, jnp.asarray(TS), (p, JDoseContext(t, a)), max_steps=256)[0]

        return jnp.sum(jax.vmap(one, out_axes=1)(z, jnp.asarray(times), jnp.asarray(amounts)) * w)

    j_val, (j_gy, j_gml) = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1)))(jnp.asarray(y0), jparams["ml_net"])
    params = params_from_jax(jparams, device="cpu")
    y = torch.from_numpy(y0).requires_grad_(True)
    ys, _ = odeint_dopri5(roche_field, y, TS, (params, DoseContext(torch.from_numpy(times), torch.from_numpy(amounts))),
                          max_steps=256, per_row=True)
    val = torch.sum(ys * torch.from_numpy(w))
    val.backward()
    np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-4)
    ml = params["ml_net"][0]
    for name, g, jg in (("y0", y.grad, j_gy), ("ml_net.w", ml["w"].grad, j_gml[0]["w"]),
                        ("ml_net.b", ml["b"].grad, j_gml[0]["b"])):
        g, jg = g.numpy(), np.asarray(jg)
        assert np.isfinite(g).all() and np.isfinite(jg).all(), name
        assert np.max(np.abs(g - jg)) <= 2e-3 * np.max(np.abs(jg)) + 1e-6, name
    assert params["expert"]["kel"].grad is None  # the frozen constants get no gradient


def test_per_row_dose_does_not_leak_across_rows(case):
    """Each row of a per-row solve equals that patient solved alone."""
    jparams, y0, times, amounts = case
    together = _port_solve(jparams, y0, times, amounts, True, torch.float64)
    for i in range(0, B, 3):
        alone = _port_solve(jparams, y0[i:i + 1], times[i:i + 1], amounts[i:i + 1], True, torch.float64)
        np.testing.assert_array_equal(together[2][i:i + 1], alone[2])
        np.testing.assert_allclose(together[0][:, i:i + 1], alone[0], rtol=1e-12, atol=1e-15)


def test_dose_functions_refuse_a_flat_per_row_time():
    """A (B,) time would broadcast against (B, K) dose times into (B, B); (B, 1) is the per-row shape."""
    ctx = DoseContext(times=torch.tensor([[0.0], [3.0], [5.0]]), amounts=torch.tensor([1.0, 2.0, 4.0]))
    t = torch.tensor([4.0, 4.0, 4.0])
    for fn in (lambda t: exp_decay_dose(t, ctx, 1.0), lambda t: impulse_dose(t, ctx)):
        with pytest.raises(ValueError, match=r"\(B, 1\)"):
            fn(t)
    per_row = exp_decay_dose(t[:, None], ctx, 1.0)
    one_by_one = torch.stack([exp_decay_dose(t[i], DoseContext(ctx.times[i:i + 1], ctx.amounts[i:i + 1]), 1.0)[0]
                              for i in range(3)])
    torch.testing.assert_close(per_row, one_by_one)
    assert per_row[2] == 0.0  # patient 2 is dosed at t=5, not yet at t=4
    np.testing.assert_array_equal(impulse_dose(torch.tensor([[0.0], [3.0], [4.0]]), ctx).numpy(), [1.0, 2.0, 0.0])


def test_neural_field_lockstep_matches_jax(case):
    """The black-box neural field with its impulse dose, in lockstep at the CLI's budget of 512 (float64)."""
    _, y0, times, amounts = case
    jparams = j_init_neural_field(jax.random.PRNGKey(2), D)
    x = np.random.RandomState(2).randn(B, D).astype(np.float32)
    t = np.float32(3.0)  # patients dosed at t=3 see their impulse
    params = params_from_jax(jparams, device="cpu")
    jctx = JDoseContext(jnp.asarray(times), jnp.asarray(amounts))
    np.testing.assert_allclose(
        neural_field(torch.tensor(t), torch.from_numpy(x), (params.requires_grad_(False), DoseContext(torch.from_numpy(times),
                                                                                torch.from_numpy(amounts)))).numpy(),
        np.asarray(j_neural_field(jnp.asarray(t), jnp.asarray(x), (jparams, jctx))), rtol=1e-5, atol=1e-6)
    with jax.enable_x64(True):
        want = _jax_solve(jparams, y0, times, amounts, False, jnp.float64, field=j_neural_field, max_steps=512)
    got = _port_solve(jparams, y0, times, amounts, False, torch.float64, field=neural_field, max_steps=512)
    assert bool(got[3]) and bool(want[3])
    assert (int(got[1]), int(got[2])) == (int(want[1]), int(want[2]))
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL64, atol=ATOL64)


@pytest.mark.parametrize("per_row", [False, True], ids=["lockstep", "per_row"])
def test_checkpoint_steps_changes_no_value_and_no_gradient(per_row):
    """`checkpoint_steps=True` (JAX's default; the port's is False) recomputes each chunk of 64 trial steps in the
    backward pass: in float64 on 8 patients' doses, the trajectory, the step counts and the gradients with respect
    to y0 and every trainable leaf are those without it, bit for bit."""
    from hybridode_torch.data import SyntheticCohort
    from hybridode_torch.fields import doses_from_actions, init_roche_field

    c = SyntheticCohort.load(COHORT, device="cpu")
    ctx = doses_from_actions(c.get_split("train", 8, 0)["actions"].double(), 1.0)
    ode = init_roche_field(torch.Generator().manual_seed(0), 6, device="cpu").double()
    leaves = [p for p in ode.parameters() if p.requires_grad]
    y0 = torch.rand(8, 6, generator=torch.Generator().manual_seed(1), dtype=torch.float64) * 2
    runs = []
    for checkpoint_steps in (False, True):
        y = y0.clone().requires_grad_()
        ys, st = odeint_dopri5(roche_field, y, torch.arange(15, dtype=torch.float64), (ode, ctx), rtol=1e-7,
                               atol=1e-8, max_steps=256 if per_row else 512, per_row=per_row,
                               checkpoint_steps=checkpoint_steps)
        grads = torch.autograd.grad((ys[1:] ** 2).sum(), [y] + leaves)
        runs.append((ys.detach(), st.n_steps, grads))
    (ys, n, grads), (ys_c, n_c, grads_c) = runs
    assert torch.equal(ys, ys_c) and torch.equal(n, n_c) and int(n.max()) > 64  # more than one chunk
    for g, g_c in zip(grads, grads_c):
        assert torch.equal(g, g_c)
    with torch.no_grad():  # without grad mode nothing is checkpointed, the same values
        assert torch.equal(odeint_dopri5(roche_field, y0, torch.arange(15, dtype=torch.float64), (ode, ctx),
                                         rtol=1e-7, atol=1e-8, max_steps=256 if per_row else 512, per_row=per_row,
                                         checkpoint_steps=True)[0], ys)
