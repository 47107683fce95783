"""The RK4 Roche trajectory: the port's plain version vs the Pallas kernel and JAX's RK4.

Mirrors the four cases of tests/test_pallas.py (latent 6, 4 and 8 - the
no-pad case - and a batch of 7) with their tolerances rtol=2e-3, atol=5e-4
(summation-order differences amplified near the |x|**p kink). The Pallas
kernel runs with interpret=True, as the JAX package's own tests run it.

The `cuda` case holds the CUDA kernel against the plain version on the card
and skips without one. JAX is imported inside the helpers only, so that case
also runs where JAX is not installed:
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_roche_rk4.py`.
"""

import numpy as np
import pytest
import torch

from hybridode_torch.convert import params_from_jax
from hybridode_torch.fields import init_roche_field
from hybridode_torch.ops import roche_rk4
from hybridode_torch.ops.roche_rk4 import _check, roche_rk4_trajectory, roche_rk4_trajectory_reference

RTOL, ATOL = 2e-3, 5e-4
# Kernel vs plain version on one card: float32 rounding of two evaluation orders.
CUDA_RTOL, CUDA_ATOL = 1e-4, 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _setup(latent, B=20, seed=0):
    """The inputs of tests/test_pallas.py: JAX params (tamed remainder), numpy draws."""
    import jax

    from hybridode.fields import init_roche_field as j_init_roche_field

    rng = np.random.RandomState(seed)
    jparams = j_init_roche_field(jax.random.PRNGKey(seed), latent)
    if "ml_net" in jparams:
        jparams["ml_net"][0]["w"] = jparams["ml_net"][0]["w"] * 0.2
        jparams["ml_net"][0]["b"] = jparams["ml_net"][0]["b"] * 0.0
    y0 = rng.exponential(0.02, (B, latent)).astype(np.float32)
    times = rng.randint(0, 5, B).astype(np.float32)
    amounts = (rng.rand(B) * 2).astype(np.float32)
    ts = np.arange(0.0, 6.0, dtype=np.float32)
    return jparams, y0, times, amounts, ts


def _jax_refs(jparams, y0, times, amounts, ts, n_sub):
    import jax.numpy as jnp

    from hybridode.fields import DoseContext, roche_field
    from hybridode.ops.pallas import roche_rk4_trajectory as pallas_rk4
    from hybridode.solvers import odeint

    ml = jparams.get("ml_net")
    pallas = pallas_rk4(jnp.asarray(y0), jnp.asarray(times), jnp.asarray(amounts), jparams["expert"],
                        ml[0]["w"] if ml else None, ml[0]["b"] if ml else None, jnp.asarray(ts),
                        n_substeps=n_sub, interpret=True)
    ctx = DoseContext(times=jnp.asarray(times)[:, None], amounts=jnp.asarray(amounts))
    scan = odeint(roche_field, jnp.asarray(y0), jnp.asarray(ts), (jparams, ctx), method="rk4", n_substeps=n_sub)
    return np.asarray(pallas), np.asarray(scan)


def _port_call(fn, jparams, y0, times, amounts, ts, n_sub):
    p = params_from_jax(jparams, device="cpu")
    ml = p["ml_net"][0] if "ml_net" in p else None
    with torch.no_grad():
        return fn(torch.from_numpy(y0), torch.from_numpy(times), torch.from_numpy(amounts), p["expert"],
                  None if ml is None else ml["w"], None if ml is None else ml["b"], torch.from_numpy(ts), n_sub)


@pytest.mark.parametrize("latent,B,n_sub", [(6, 20, 2), (4, 20, 2), (8, 20, 2), (6, 7, 1)],
                         ids=["hybrid", "expert_only", "full_width_no_pad", "batch_padding"])
def test_plain_version_matches_pallas_and_jax_rk4(latent, B, n_sub):
    jparams, y0, times, amounts, ts = _setup(latent, B)
    pallas, scan = _jax_refs(jparams, y0, times, amounts, ts, n_sub)
    got = _port_call(roche_rk4_trajectory_reference, jparams, y0, times, amounts, ts, n_sub).numpy()
    assert got.shape == (len(ts), B, latent)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, scan, rtol=RTOL, atol=ATOL)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    jparams, y0, times, amounts, ts = _setup(6, B=7)
    roche_rk4_trajectory.launches = 0
    got = _port_call(roche_rk4_trajectory, jparams, y0, times, amounts, ts, 2)
    want = _port_call(roche_rk4_trajectory_reference, jparams, y0, times, amounts, ts, 2)
    assert roche_rk4_trajectory.launches == 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["D_too_large", "ml_w_missing", "ml_b_shape", "times_shape", "dtype", "grad"])
def test_kernel_argument_checks(bad):
    B, D, T = 5, 6, 4
    args = dict(y0=torch.zeros(B, D), times=torch.zeros(B), amounts=torch.zeros(B), params=torch.zeros(13),
                ml_w=torch.zeros(D, D - 4), ml_b=torch.zeros(D - 4), ts=torch.arange(float(T)), n_substeps=2)
    assert _check(**args) == (B, D, T)
    if bad == "D_too_large":
        args.update(y0=torch.zeros(B, 9), ml_w=torch.zeros(9, 5), ml_b=torch.zeros(5))
    elif bad == "ml_w_missing":
        args.update(ml_w=None)
    elif bad == "ml_b_shape":
        args.update(ml_b=torch.zeros(3))
    elif bad == "times_shape":
        args.update(times=torch.zeros(B, 1))
    elif bad == "dtype":
        args.update(amounts=torch.zeros(B, dtype=torch.float64))
    else:
        args.update(ml_w=torch.zeros(D, D - 4, requires_grad=True))
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        _check(**args)


@pytest.mark.cuda
@pytest.mark.parametrize("B,D", [(2500, 6), (50, 6), (1000, 4), (1000, 8), (7, 6)])
def test_cuda_kernel_matches_plain_version(cuda_device, B, D):
    gen = torch.Generator().manual_seed(B + D)
    field = init_roche_field(gen, D, device="cpu")
    y0 = torch.exp(0.3 * torch.randn(B, D, generator=gen)) / 10
    times = torch.randint(0, 14, (B,), generator=gen).float()
    amounts = torch.rand(B, generator=gen) * 10
    ml = field["ml_net"][0] if D > 4 else None
    dev = lambda x: None if x is None else x.detach().to(cuda_device)  # noqa: E731
    args = (dev(y0), dev(times), dev(amounts), {k: dev(field["expert"][k]) for k in field["expert"].keys()},
            dev(None if ml is None else ml["w"]), dev(None if ml is None else ml["b"]),
            torch.arange(15.0, device=cuda_device), 8)
    roche_rk4.roche_rk4_trajectory.launches = 0
    with torch.no_grad():
        got = roche_rk4_trajectory(*args)
        want = roche_rk4_trajectory_reference(*args)
    torch.cuda.synchronize()
    assert roche_rk4.roche_rk4_trajectory.launches == 1
    torch.testing.assert_close(got, want, rtol=CUDA_RTOL, atol=CUDA_ATOL)
