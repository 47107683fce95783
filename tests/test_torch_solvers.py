"""Port vs JAX: the fixed-step integrators on the Roche field, on the CPU.

Both packages do the same float32 arithmetic in the same order; what differs
is ulp-level rounding in the field's transcendentals and matmul, grown over
the solve. Tolerance rtol=1e-5, atol=1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridode.fields import DoseContext as JDoseContext
from hybridode.fields import init_roche_field as j_init_roche_field
from hybridode.fields import roche_field as j_roche_field
from hybridode.solvers import odeint_fixed as j_odeint_fixed
from hybridode_torch.convert import params_from_jax
from hybridode_torch.fields import DoseContext, roche_field
from hybridode_torch.solvers import odeint, odeint_dopri5, odeint_fixed

RTOL, ATOL = 1e-5, 1e-6


def _setup(seed=0, B=16, latent=6):
    rng = np.random.RandomState(seed)
    jparams = j_init_roche_field(jax.random.PRNGKey(seed), latent)
    jparams["ml_net"][0]["w"] = jparams["ml_net"][0]["w"] * 0.2
    y0 = rng.exponential(0.02, (B, latent)).astype(np.float32)
    times = rng.randint(0, 5, (B, 1)).astype(np.float32)
    amounts = (rng.rand(B) * 2).astype(np.float32)
    return jparams, y0, times, amounts


@pytest.mark.parametrize("method", ["rk4", "midpoint", "euler", "explicit_adams"])
@pytest.mark.parametrize("n_substeps,step_size", [(2, None), (None, 0.25)])
def test_odeint_fixed_matches_jax(method, n_substeps, step_size):
    jparams, y0, times, amounts = _setup()
    ts = np.arange(0.0, 6.0, dtype=np.float32)
    want = j_odeint_fixed(j_roche_field, jnp.asarray(y0), jnp.asarray(ts),
                          (jparams, JDoseContext(jnp.asarray(times), jnp.asarray(amounts))),
                          method=method, step_size=step_size, n_substeps=n_substeps)
    params = params_from_jax(jparams, device="cpu")
    with torch.no_grad():
        got = odeint_fixed(roche_field, torch.from_numpy(y0), torch.from_numpy(ts),
                           (params, DoseContext(torch.from_numpy(times), torch.from_numpy(amounts))),
                           method=method, step_size=step_size, n_substeps=n_substeps)
    assert got.shape == (len(ts), *y0.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_dopri5_is_not_ported_and_does_not_fall_back():
    """The name predates the DOPRI5 port: `odeint(method="dopri5")` now routes to the
    adaptive lockstep solver and never falls back to a fixed-step method."""
    y0, ts = torch.ones(2, 3), torch.arange(3.0)
    got = odeint(lambda t, y, args: -y, y0, ts, method="dopri5")
    want, stats = odeint_dopri5(lambda t, y, args: -y, y0, ts)
    assert bool(stats.success) and int(stats.n_accepted) > len(ts)  # adaptive steps, not one per interval
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    np.testing.assert_allclose(got[:, 0, 0].numpy(), np.exp(-ts.numpy()), rtol=1e-5)


def test_unknown_method_raises():
    with pytest.raises(ValueError):
        odeint(lambda t, y, args: -y, torch.ones(2, 3), torch.arange(3.0), method="rk45")
