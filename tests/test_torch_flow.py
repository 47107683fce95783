"""Port vs JAX: the three flows, the planar-flow encoder, the flow posterior's KL, loss, gradients and forecast.

The flows and the encoder run on numpy draws from a seed; the non-square
Sylvester cases take M = 3 < D = 6. The loss is the CLI's flow model
(`build_sim_model("hybrid", flow=True, mc_size=50)`: per-patient DOPRI5,
max_steps=256, 4 planar flows, Exponential prior) on 8 patients of data_s123;
the `mc_size == 1` branch runs at an RK4 decoder (step 0.125). JAX draws the
noise from its keys; the port is handed exactly those draws.

Tolerances: flows and encoder rtol 1e-5, atol 1e-6 (float32 transcendentals
may differ by an ulp; the softplus above 20 is x in PyTorch, log1p(exp(x)) in
JAX, equal in float32); the loss rtol 1e-4 and every gradient leaf within
2e-3 of its largest JAX entry, as tests/test_torch_train.py holds the sim
loss (two float32 DOPRI5 solves whose step sequences may differ).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridode.cli.common import build_sim_model as j_build_sim_model
from hybridode.config import DataConfig as JDataConfig
from hybridode.data import SyntheticCohort as JSyntheticCohort
from hybridode.inference import elbo as j_elbo
from hybridode.inference import init_vi as j_init_vi
from hybridode.inference import load_checkpoint as j_load_checkpoint
from hybridode.inference import save_checkpoint as j_save_checkpoint
from hybridode.models import encoders as j_encoders
from hybridode.models import flows as j_flows
from hybridode.models import priors as j_priors
from hybridode_torch.cli.common import build_sim_model
from hybridode_torch.config import DataConfig
from hybridode_torch.convert import params_from_jax, params_to_jax
from hybridode_torch.data import SyntheticCohort
from hybridode_torch.inference import elbo, load_checkpoint, save_checkpoint
from hybridode_torch.models import encoders, flows, priors

COHORT = os.path.join(os.path.dirname(__file__), os.pardir, "data_s123", "datafile_dose_exp.pkl")
RTOL, ATOL = 1e-5, 1e-6
B, D, M, K = 8, 6, 3, 4


@pytest.fixture(scope="module")
def cohorts():
    return JSyntheticCohort.load(COHORT), SyntheticCohort.load(COHORT, device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _close(got, want, rtol=RTOL, atol=ATOL):
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=rtol, atol=atol)


def _models(mc_size=50, method="dopri5"):
    jm = j_build_sim_model("hybrid", JDataConfig(), flow=True, num_flows=K, mc_size=mc_size, ode_method=method)
    m = build_sim_model("hybrid", DataConfig(), flow=True, num_flows=K, mc_size=mc_size, ode_method=method)
    if method == "rk4":
        jm = jm._replace(decoder_spec=jm.decoder_spec._replace(ode_step_size=0.125))
        m = m._replace(decoder_spec=m.decoder_spec._replace(ode_step_size=0.125))
    return jm, m


def _normals(key, shape, n=None):
    """JAX's draws from `key` (n=None) or one draw from each of split(key, n)."""
    if n is None:
        return np.array(jax.random.normal(key, shape, jnp.float32))
    return np.stack([np.array(jax.random.normal(k, shape, jnp.float32)) for k in jax.random.split(key, n)])


@pytest.mark.parametrize("scale", [0.5, 8.0], ids=["uw_small", "uw_above_20"])
def test_planar_flow_matches_jax(scale):
    rng = np.random.RandomState(0)
    z, u, w, b = (rng.randn(*s).astype(np.float32) for s in ((B, D), (B, D, 1), (B, 1, D), (B, 1, 1)))
    u, w = u * scale, np.abs(w) * scale * np.sign(u.transpose(0, 2, 1))  # scale 8: every w.u is above 20
    uw = np.einsum("bod,bdo->b", w, u)
    assert (uw > 20).all() if scale > 1 else (np.abs(uw) < 20).all()
    want = j_flows.planar_flow(*(jnp.asarray(a) for a in (z, u, w, b)))
    _close(flows.planar_flow(*(torch.from_numpy(a) for a in (z, u, w, b))), want)


def test_planar_flow_broadcasts_mc_draws_over_one_patients_parameters():
    rng = np.random.RandomState(1)
    z = torch.from_numpy(rng.randn(5, B, D).astype(np.float32))
    u, w, b = (torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((B, D, 1), (B, 1, D), (B, 1, 1)))
    z_all, ldj_all = flows.planar_flow(z, u, w, b)
    assert z_all.shape == (5, B, D) and ldj_all.shape == (5, B)
    for i in range(5):
        z_i, ldj_i = flows.planar_flow(z[i], u, w, b)
        torch.testing.assert_close(z_all[i], z_i, rtol=0, atol=1e-6)
        torch.testing.assert_close(ldj_all[i], ldj_i, rtol=0, atol=1e-6)


@pytest.mark.parametrize("sum_ldj", [True, False])
def test_sylvester_flow_matches_jax(sum_ldj):
    rng = np.random.RandomState(2)
    z = rng.randn(B, D).astype(np.float32)
    r1, r2 = (np.triu(rng.randn(B, M, M)).astype(np.float32) for _ in range(2))
    q = np.linalg.qr(rng.randn(B, D, M))[0].astype(np.float32)  # (B, D, M) orthonormal columns
    bias = rng.randn(B, 1, M).astype(np.float32)
    want = j_flows.sylvester_flow(*(jnp.asarray(a) for a in (z, r1, r2, q, bias)), sum_ldj=sum_ldj)
    got = flows.sylvester_flow(*(torch.from_numpy(a) for a in (z, r1, r2, q, bias)), sum_ldj=sum_ldj)
    assert got[0].shape == (B, D) and got[1].shape == ((B,) if sum_ldj else (B, M))
    _close(got, want)


@pytest.mark.parametrize("permute", [False, True])
@pytest.mark.parametrize("n", [D, M], ids=["square", "M_below_D"])
def test_triangular_sylvester_flow_matches_jax(permute, n):
    rng = np.random.RandomState(3)
    z = rng.randn(B, D).astype(np.float32)
    r1 = rng.randn(B, D, n).astype(np.float32)
    r2 = rng.randn(B, n, D).astype(np.float32)
    bias = rng.randn(B, 1, n).astype(np.float32)
    perm = np.arange(D)[::-1].copy() if permute else None
    want = j_flows.triangular_sylvester_flow(*(jnp.asarray(a) for a in (z, r1, r2, bias)),
                                             permute_z=None if perm is None else jnp.asarray(perm))
    got = flows.triangular_sylvester_flow(*(torch.from_numpy(a) for a in (z, r1, r2, bias)),
                                          permute_z=None if perm is None else torch.from_numpy(perm))
    _close(got, want)


def _encoder_case(seed=4, T=15):
    spec_j = j_encoders.EncoderPlanarLSTMSpec(21, 40, D, num_flows=K)
    spec = encoders.EncoderPlanarLSTMSpec(21, 40, D, num_flows=K)
    jp = j_encoders.init_encoder_planar_lstm(jax.random.PRNGKey(seed), spec_j)
    rng = np.random.RandomState(seed)
    x = rng.randn(T, B, 20).astype(np.float32)
    a = (rng.rand(T, B, 1) < 0.2).astype(np.float32)
    mask = (rng.rand(T, B, 20) < 0.5).astype(np.float32)
    return spec_j, spec, jp, (x, a, mask)


def test_encoder_planar_lstm_apply_matches_jax():
    spec_j, spec, jp, inputs = _encoder_case()
    assert tuple(spec) == tuple(spec_j)
    want = j_encoders.encoder_planar_lstm_apply(jp, spec_j, *(jnp.asarray(v) for v in inputs))
    got = encoders.encoder_planar_lstm_apply(params_from_jax(jp, device="cpu"), spec,
                                             *(torch.from_numpy(v) for v in inputs))
    assert [tuple(g.shape) for g in got] == [(B, D), (B, D), (B, K, D, 1), (B, K, 1, D), (B, K, 1, 1)]
    _close(got, want)
    # A random initialisation of the port has the JAX tree's leaves and shapes.
    mine = encoders.init_encoder_planar_lstm(torch.Generator().manual_seed(0), spec, device="cpu")
    assert {k: v.shape for k, v in _leaves(params_to_jax(mine))} == {k: v.shape for k, v in _leaves(jp)}


def test_planar_reparameterize_and_log_density_match_jax():
    spec_j, spec, jp, inputs = _encoder_case(seed=5)
    j_out = j_encoders.encoder_planar_lstm_apply(jp, spec_j, *(jnp.asarray(v) for v in inputs))
    out = encoders.encoder_planar_lstm_apply(params_from_jax(jp, device="cpu"), spec,
                                             *(torch.from_numpy(v) for v in inputs))
    eps = np.random.RandomState(5).randn(B, D).astype(np.float32)
    want = j_encoders.planar_reparameterize(None, j_out, K, eps=jnp.asarray(eps))
    got = encoders.planar_reparameterize(out, K, torch.from_numpy(eps))
    _close(got, want)
    assert bool((got[2] > 0).all())  # the exp(z - 5) layer
    _close([encoders.planar_log_density(*got)], [j_encoders.planar_log_density(*want)], rtol=1e-5, atol=1e-5)


def test_flow_mc_kl_matches_jax():
    spec_j, spec, jp, inputs = _encoder_case(seed=6)
    jm, m = _models(mc_size=20)
    j_out = j_encoders.encoder_planar_lstm_apply(jp, spec_j, *(jnp.asarray(v) for v in inputs))
    out = encoders.encoder_planar_lstm_apply(params_from_jax(jp, device="cpu"), spec,
                                             *(torch.from_numpy(v) for v in inputs))
    key = jax.random.PRNGKey(6)
    want = j_elbo.flow_mc_kl(key, j_out, jm, j_priors.exponential_log_density)
    got = elbo.flow_mc_kl(torch.from_numpy(_normals(key, (B, D), 20)), out, m, priors.exponential_log_density)
    assert got.shape == (B,)
    _close([got], [want], rtol=1e-5, atol=1e-4)


def _jax_flow_noise(key, mc_size):
    """The draws of JAX's flow_loss: eps from k_rep, one eps per MC sample from k_kl."""
    k_rep, k_kl = jax.random.split(key)
    return torch.from_numpy(_normals(k_rep, (B, D))), torch.from_numpy(_normals(k_kl, (B, D), mc_size))


@pytest.mark.parametrize("mc_size,method", [(50, "dopri5"), (1, "rk4")], ids=["mc50_dopri5", "mc1_rk4"])
def test_flow_loss_value_and_gradients_match_jax(cohorts, mc_size, method):
    jc, c = cohorts
    jm, m = _models(mc_size, method)
    assert m.kind == "flow" and m.mc_size == mc_size and m.decoder_spec.method == method
    jparams = j_init_vi(jax.random.PRNGKey(3), jm)
    key = jax.random.PRNGKey(5)
    j_val, j_grads = jax.jit(jax.value_and_grad(j_elbo.flow_loss), static_argnums=1)(
        jparams, jm, jc.get_split("train", B, 0), key)

    params = params_from_jax(jparams, device="cpu")
    eps, eps_kl = _jax_flow_noise(key, mc_size)
    loss = elbo.loss_fn(params, m, c.get_split("train", B, 0), eps=eps, eps_kl=eps_kl)
    loss.backward()
    assert np.isfinite(float(j_val)) and torch.isfinite(loss)
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=1e-4)

    want = dict(_leaves(j_grads))
    n_amor = 0
    for name, p in params.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and ".expert." in name, name
            continue
        g, jg = p.grad.numpy(), want[name]
        assert np.isfinite(g).all() and np.isfinite(jg).all(), name
        assert np.max(np.abs(g - jg)) <= 2e-3 * np.max(np.abs(jg)) + 1e-6, (name, np.max(np.abs(g - jg)))
        n_amor += ".amor_" in name
    assert n_amor == 6  # u, w, b heads: weights and biases


def test_flow_loss_draws_from_a_generator_in_a_fixed_order(cohorts):
    _, c = cohorts
    _, m = _models(mc_size=3, method="rk4")
    params = elbo.init_vi(torch.Generator().manual_seed(0), m, device="cpu")
    batch = c.get_split("train", B, 0)
    eps, eps_kl = elbo.draw_noise(m, B, torch.Generator().manual_seed(9), "cpu")
    assert eps.shape == (B, D) and eps_kl.shape == (3, B, D)
    with torch.no_grad():
        a = elbo.loss_fn(params, m, batch, torch.Generator().manual_seed(9))
        b = elbo.flow_loss(params, m, batch, eps=eps, eps_kl=eps_kl)
        # Without the ELBO the decoded latent is still a flow sample of the same eps.
        lik = elbo.flow_loss(params, m._replace(elbo=False), batch, torch.Generator().manual_seed(9))
        lik_eps = elbo.flow_loss(params, m._replace(elbo=False), batch, eps=eps)
    assert a.item() == b.item() and lik.item() == lik_eps.item() and lik.item() < a.item()


def test_flow_forecast_loss_matches_jax(cohorts):
    jc, c = cohorts
    jm, m = _models()
    jparams = j_init_vi(jax.random.PRNGKey(6), jm)
    params = params_from_jax(jparams, device="cpu")
    want = jax.jit(j_elbo.forecast_loss, static_argnums=(1, 3))(jparams, jm, jc.get_split("val", B, 0), 5)
    eps_point = torch.from_numpy(_normals(jax.random.PRNGKey(0), (B, D)))  # JAX's fixed PRNGKey(0) draw
    with torch.no_grad():
        num, den = elbo.forecast_loss_terms(params, m, c.get_split("val", B, 0), 5, eps_point=eps_point)
        default = elbo.forecast_loss(params, m, c.get_split("val", B, 0), 5)
        again = elbo.forecast_loss(params, m, c.get_split("val", B, 0), 5)
    assert np.isfinite(float(want)) and torch.isfinite(num)
    np.testing.assert_allclose((num / den).item(), float(want), rtol=1e-4)
    assert torch.isfinite(default) and default.item() == again.item()  # one fixed draw, the same on every call


def test_build_sim_model_flow_matches_jax():
    jm = j_build_sim_model("hybrid", JDataConfig(), flow=True, num_flows=K, mc_size=50)
    m = build_sim_model("hybrid", DataConfig(), flow=True, num_flows=K, mc_size=50)
    assert type(m.encoder_spec).__name__ == "EncoderPlanarLSTMSpec" and tuple(m.encoder_spec) == tuple(jm.encoder_spec)
    assert m.decoder_spec._asdict() == jm.decoder_spec._asdict()
    assert (m.kind, m.prior, m.elbo, m.mc_size) == (jm.kind, jm.prior, jm.elbo, jm.mc_size) == ("flow", "exponential",
                                                                                                 True, 50)
    assert m.model_name == jm.model_name == "VI_FLOW_PlanarLSTMEncoder_HybridDecoder.pkl"


def test_flow_tree_crosses_packages_bit_for_bit(tmp_path):
    jm, m = _models()
    jparams = j_init_vi(jax.random.PRNGKey(1), jm)
    params = params_from_jax(jparams, device="cpu")
    assert {k for k, _ in _leaves(jparams) if ".amor_" in k} == {f"encoder.amor_{h}.{p}" for h in "uwb" for p in "wb"}
    for (k, got), (_, want) in zip(sorted(_leaves(params_to_jax(params))), sorted(_leaves(jparams))):
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)

    j_save_checkpoint(str(tmp_path / "jax_"), jm.model_name, jparams, itr=3, best_loss=2.5)
    loaded, itr, best = load_checkpoint(str(tmp_path / "jax_"), m.model_name, device="cpu")
    assert (itr, best) == (3, 2.5)
    save_checkpoint(str(tmp_path / "port_"), m.model_name, loaded, itr=4, best_loss=2.0)
    back, itr, best = j_load_checkpoint(str(tmp_path / "port_"), jm.model_name)
    assert (itr, best) == (4, 2.0)
    for (k, got), (_, want) in zip(sorted(_leaves(back)), sorted(_leaves(jparams))):
        np.testing.assert_array_equal(got, want, err_msg=k)
