"""Port vs JAX: dose extraction, exp-decay dose and the Roche field on the CPU.

Inputs come from numpy.random.RandomState; JAX parameters reach the port via
convert.params_from_jax. Tolerance rtol=1e-6 (float32 transcendentals may
differ by an ulp between XLA and PyTorch), atol=1e-7 for the entries that
cancel to ~0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridode.fields import DoseContext as JDoseContext
from hybridode.fields import doses_from_actions as j_doses_from_actions
from hybridode.fields import exp_decay_dose as j_exp_decay_dose
from hybridode.fields import init_roche_field as j_init_roche_field
from hybridode.fields import roche_field as j_roche_field
from hybridode_torch.convert import params_from_jax
from hybridode_torch.fields import NO_DOSE_TIME, DoseContext, doses_from_actions, exp_decay_dose, roche_field

RTOL, ATOL = 1e-6, 1e-7


def _actions(seed=0, T=15, B=6):
    """Patient 0 has no dose, patient 1 two nonzero actions, the rest one each."""
    rng = np.random.RandomState(seed)
    a = np.zeros((T, B, 1), np.float32)
    a[3, 1, 0], a[9, 1, 0] = 2.5, 4.0
    for b in range(2, B):
        a[rng.randint(0, T - 1), b, 0] = rng.rand() * 10
    return a


@pytest.mark.parametrize("max_doses", [1, 2])
@pytest.mark.parametrize("step_size", [1.0, 0.5])
def test_doses_from_actions(max_doses, step_size):
    a = _actions()
    want = j_doses_from_actions(jnp.asarray(a), step_size, max_doses)
    got = doses_from_actions(torch.from_numpy(a), step_size, max_doses)
    np.testing.assert_array_equal(got.times.numpy(), np.asarray(want.times))
    np.testing.assert_array_equal(got.amounts.numpy(), np.asarray(want.amounts))
    assert got.times[0, 0] == NO_DOSE_TIME  # no dose
    assert got.times[1, 0] == 3 * step_size  # earliest of the two nonzero actions


@pytest.mark.parametrize("t", [0.0, 3.0, 3.5, 9.25, 14.0])
@pytest.mark.parametrize("kel", [1.0, 0.7])
def test_exp_decay_dose(t, kel):
    a = _actions(seed=1)
    jctx = j_doses_from_actions(jnp.asarray(a), 1.0, 2)
    ctx = doses_from_actions(torch.from_numpy(a), 1.0, 2)
    want = j_exp_decay_dose(jnp.float32(t), jctx, jnp.float32(kel))
    got = exp_decay_dose(torch.tensor(t), ctx, torch.tensor(kel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("latent,ablate", [(4, False), (6, False), (8, False), (6, True)])
def test_roche_field(latent, ablate):
    rng = np.random.RandomState(latent)
    jparams = j_init_roche_field(jax.random.PRNGKey(latent), latent, ablate=ablate)
    params = params_from_jax(jparams, device="cpu")
    B = 32
    y = (rng.randn(B, latent) * 0.3).astype(np.float32)  # states on both sides of 0 (the |x|**p kink)
    times = rng.randint(0, 8, (B, 1)).astype(np.float32)
    amounts = (rng.rand(B) * 10).astype(np.float32)
    for t in (0.0, 4.25, 7.5):
        want = j_roche_field(jnp.float32(t), jnp.asarray(y), (jparams, JDoseContext(jnp.asarray(times), jnp.asarray(amounts))))
        with torch.no_grad():
            got = roche_field(torch.tensor(t), torch.from_numpy(y),
                              (params, DoseContext(torch.from_numpy(times), torch.from_numpy(amounts))))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_expert_constants_are_frozen():
    params = params_from_jax(j_init_roche_field(jax.random.PRNGKey(0), 6, ablate=True), device="cpu")
    frozen = {n for n, p in params.named_parameters() if not p.requires_grad}
    assert frozen == {f"expert.{k}" for k in params["expert"].keys()} | {"theta_1", "theta_2"}
    assert len(params["expert"].keys()) == 13
