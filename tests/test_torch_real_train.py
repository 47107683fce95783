"""Port vs JAX: the real track's loss and gradients, its forecast loss, and its training loop.

A stand-in cohort (40 patients: 16 train / 8 val / 16 test, T 14, obs 5,
3 statics) written by the port, read by both packages; the hybrid model of
`build_real_model` at t0 6 with 6 latents. The loss is `jax.value_and_grad`
of JAX's `real_loss`, compiled once per module. Tolerances: loss values
rtol 1e-5 (13 steps of explicit Adams in float32), each gradient leaf
|g_port - g_jax| <= 2e-3 max|g_jax| + 1e-6. The ELBO variants get JAX's own
noise draws. The training loop (shuffle=False, train_expert=True, 4
iterations, validation every 2; no noise: elbo=False) keeps its curve within
rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridode.cli.common import build_real_model as j_build_real_model
from hybridode.data import RealCohort as JRealCohort
from hybridode.inference import elbo as j_elbo
from hybridode.inference import init_vi as j_init_vi
from hybridode.inference import variational_training_loop as j_training_loop
from hybridode_torch.cli.common import build_real_model
from hybridode_torch.convert import params_from_jax
from hybridode_torch.data import RealCohort, make_real_standin
from hybridode_torch.inference import elbo, variational_training_loop

T0, LATENT, B = 6, 6, 8
GRAD_REL = 2e-3


@pytest.fixture(scope="module")
def cohort_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("real")) + "/"
    make_real_standin(path, n_sample=40, t_max=14, obs_dim=5, static_dim=3, latent_dim=4)
    return path


@pytest.fixture(scope="module")
def cohorts(cohort_path):
    jc, c = JRealCohort(cohort_path, val_size=8, test_size=16), RealCohort(cohort_path, val_size=8, test_size=16,
                                                                          device="cpu")
    jc.split_sample()
    c.split_sample()
    return jc, c


def _models(c, method="hybrid", **kw):
    args = (method, c.obs_dim, c.action_dim, c.static_dim, c.t_max, c.step_size)
    kw = dict(encoder_output_dim=LATENT, t0=T0, **kw)
    return j_build_real_model(*args, **kw), build_real_model(*args, **kw)


@pytest.fixture(scope="module")
def jax_value_and_grad():
    """real_loss's value and gradient, one compiled JAX function per (model, key) the module asks for."""
    return jax.jit(jax.value_and_grad(j_elbo.real_loss), static_argnums=1)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _jax_noise(key, mc_size, shape):
    """The draws of JAX's real_loss: eps from k_rep, one eps per MC sample from k_kl."""
    k_rep, k_kl = jax.random.split(key)
    eps = np.array(jax.random.normal(k_rep, shape, jnp.float32))
    eps_kl = np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32)) for k in jax.random.split(k_kl, mc_size)])
    return torch.from_numpy(eps), torch.from_numpy(eps_kl)


def _check_loss_and_grads(jax_value_and_grad, jm, m, jc, c, key, **noise):
    jparams = j_init_vi(jax.random.PRNGKey(3), jm)
    j_val, j_grads = jax_value_and_grad(jparams, jm, jc.get_split("train", B, 1), key)
    params = params_from_jax(jparams, device="cpu")
    loss = elbo.loss_fn(params, m, c.get_split("train", B, 1), **noise)
    loss.backward()
    assert np.isfinite(float(j_val)) and torch.isfinite(loss)
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=1e-5)
    want = dict(_leaves(j_grads))
    names = dict(params.named_parameters())
    assert names.keys() == want.keys()
    for name, p in names.items():
        jg = want[name]
        if p.grad is None:  # the log-variance head when nothing samples: JAX's gradient is exactly 0
            assert not m.elbo and name.startswith("encoder.log_var.") and not jg.any(), name
            continue
        g = p.grad.numpy()
        assert g.shape == jg.shape and np.isfinite(g).all(), name
        assert np.max(np.abs(g - jg)) <= GRAD_REL * np.max(np.abs(jg)) + 1e-6, (name, np.max(np.abs(g - jg)))
    return loss.item()


@pytest.mark.parametrize("weight", [False, True])
def test_real_loss_value_and_every_gradient_leaf_match_jax(cohorts, jax_value_and_grad, weight):
    jc, c = cohorts
    jm, m = _models(c, weight=weight)
    assert not m.elbo and m.decoder_spec.method == "explicit_adams"
    _check_loss_and_grads(jax_value_and_grad, jm, m, jc, c, jax.random.PRNGKey(0))


@pytest.mark.parametrize("prior", [None, "exponential"])
def test_real_loss_elbo_with_explicit_noise_matches_jax(cohorts, jax_value_and_grad, prior):
    jc, c = cohorts
    jm, m = _models(c)
    jm, m = jm._replace(elbo=True, prior=prior, mc_size=5), m._replace(elbo=True, prior=prior, mc_size=5)
    key = jax.random.PRNGKey(4)
    eps, eps_kl = _jax_noise(key, 5, (B, LATENT))
    _check_loss_and_grads(jax_value_and_grad, jm, m, jc, c, key, eps=eps, eps_kl=eps_kl if prior else None)


def test_real_loss_draws_from_a_generator_only_under_the_elbo(cohorts):
    _, c = cohorts
    _, m = _models(c, method="gruode")
    params = elbo.init_vi(torch.Generator().manual_seed(0), m, device="cpu")
    batch = c.get_split("train", B, 0)
    gen = torch.Generator().manual_seed(1)
    state = gen.get_state()
    with torch.no_grad():
        a = elbo.real_loss(params, m, batch, gen)
        assert torch.equal(gen.get_state(), state)  # the masked MSE draws nothing
        me = m._replace(elbo=True)
        eps, _ = elbo.draw_noise(me, B, torch.Generator().manual_seed(1), "cpu")
        b = elbo.real_loss(params, me, batch, gen)
        c_ = elbo.real_loss(params, me, batch, eps=eps)
    assert b.item() == c_.item() and b.item() != a.item()


@pytest.mark.parametrize("method", ["hybrid", "tlstm"])
def test_real_forecast_loss_matches_jax(cohorts, method):
    jc, c = cohorts
    jm, m = _models(c, method=method)
    jparams = j_init_vi(jax.random.PRNGKey(6), jm)
    want = j_elbo.forecast_loss(jparams, jm, jc.get_split("val", B, 0), T0)
    with torch.no_grad():
        got = elbo.forecast_loss(params_from_jax(jparams, device="cpu"), m, c.get_split("val", B, 0), T0)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_real_training_loop_matches_jax_host_loop(cohorts, cohort_path, tmp_path):
    jc, c = cohorts
    jm, m = _models(c)
    jparams = j_init_vi(jax.random.PRNGKey(0), jm)
    params = params_from_jax(jparams, device="cpu")
    kw = dict(niters=4, batch_size=B, lr=0.01, test_freq=2, shuffle=False, train_expert=True, early_stop=10,
              verbose=False)
    j_out = j_training_loop(data_generator=jc, model=jm, params=jparams, key=jax.random.PRNGKey(0),
                            path=str(tmp_path / "jax_"), fused=False, curve_path=str(tmp_path / "jax.csv"), **kw)
    out = variational_training_loop(data_generator=c, model=m, params=params,
                                    generator=torch.Generator().manual_seed(0), path=str(tmp_path / "port_"),
                                    curve_path=str(tmp_path / "port.csv"), **kw)
    j_curve = np.loadtxt(tmp_path / "jax.csv", delimiter=",").reshape(-1, 3)
    curve = np.loadtxt(tmp_path / "port.csv", delimiter=",").reshape(-1, 3)
    assert curve.shape == (2, 3) and np.isfinite(curve).all()
    np.testing.assert_array_equal(curve[:, 0], [2, 4])
    np.testing.assert_allclose(curve, j_curve, rtol=1e-4)
    np.testing.assert_allclose(out[1], j_out[1], rtol=1e-4)
    # Every leaf trained, the 0-d rate constants too.
    for k in ("k_immunity", "kel", "kel2"):
        got = out[0]["decoder"]["ode"][k].item()
        assert got != float(jparams["decoder"]["ode"][k]), k
        np.testing.assert_allclose(got, float(j_out[0]["decoder"]["ode"][k]), rtol=1e-4)
