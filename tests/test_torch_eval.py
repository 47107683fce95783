"""Port vs JAX: CRPS, the cohort loader, the decoder, one evaluation chunk and `evaluate`.

`_eval_chunk` runs on 8 test patients of data_s123 with the hybrid model
decoding by RK4 at the slice's ode_step_size=0.125 (8 substeps), mc_itr=4 and
t0=5. (At 0.5 some randomly initialised posterior decodes of this stiff field
overflow to NaN in both packages, and NaN == NaN would make the comparison
vacuous; every output is checked finite here.) The port
gets the exact noise JAX draws inside its `_eval_chunk`
(hybridode/eval/metrics.py:93-102), so both decode the same posterior samples.
Tolerance rtol=2e-3, atol=5e-4, as for the RK4 trajectory: float32 rounding
of two evaluation orders, amplified near the |x|**p kink of the field.
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
from hybridode.eval import crps_ensemble as j_crps_ensemble
from hybridode.eval.metrics import _eval_chunk as j_eval_chunk
from hybridode.inference import init_vi as j_init_vi
from hybridode.models import decoders as j_decoders
from hybridode.models import priors as j_priors
from hybridode_torch import resolve_device
from hybridode_torch.cli.common import build_sim_model
from hybridode_torch.config import DataConfig
from hybridode_torch.convert import params_from_jax
from hybridode_torch.data import SyntheticCohort
from hybridode_torch.eval import crps_ensemble, evaluate
from hybridode_torch.eval.metrics import _eval_chunk
from hybridode_torch.inference import init_vi
from hybridode_torch.models import decoders, priors
from hybridode_torch.ops import roche_rk4

RTOL, ATOL = 2e-3, 5e-4
COHORT = os.path.join(os.path.dirname(__file__), os.pardir, "data_s123", "datafile_dose_exp.pkl")
T0, MC, B = 5, 4, 8


@pytest.fixture(scope="module")
def cohorts():
    return JSyntheticCohort.load(COHORT), SyntheticCohort.load(COHORT, device="cpu")


def _models(step=0.125):
    jm = j_build_sim_model("hybrid", JDataConfig(), ode_method="rk4")
    jm = jm._replace(decoder_spec=jm.decoder_spec._replace(ode_step_size=step))
    m = build_sim_model("hybrid", DataConfig(), ode_method="rk4")
    m = m._replace(decoder_spec=m.decoder_spec._replace(ode_step_size=step))
    return jm, m


def test_crps_ensemble():
    rng = np.random.RandomState(0)
    truth = rng.randn(3, 4).astype(np.float32)
    samples = rng.randn(3, 4, 17).astype(np.float32)
    want = j_crps_ensemble(jnp.asarray(truth), jnp.asarray(samples))
    got = crps_ensemble(torch.from_numpy(truth), torch.from_numpy(samples))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_priors():
    rng = np.random.RandomState(1)
    mu, log_var, eps = (rng.randn(5, 6).astype(np.float32) for _ in range(3))
    z = np.abs(rng.randn(5, 6)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (mu, log_var, eps, z)]
    j = [jnp.asarray(a) for a in (mu, log_var, eps, z)]
    pairs = [
        (priors.gaussian_reparameterize(t[0], t[1], t[2]), j_priors.gaussian_reparameterize(None, j[0], j[1], j[2])),
        (priors.gaussian_log_density(t[0], t[1], t[3]), j_priors.gaussian_log_density(j[0], j[1], j[3])),
        (priors.standard_normal_log_density(t[3]), j_priors.standard_normal_log_density(j[3])),
        (priors.exponential_log_density(t[3]), j_priors.exponential_log_density(j[3])),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["hybrid", "expert"])
def test_build_sim_model_matches_jax(method):
    jm = j_build_sim_model(method, JDataConfig(), ode_method="rk4")
    m = build_sim_model(method, DataConfig(), ode_method="rk4")
    assert tuple(m.encoder_spec) == tuple(jm.encoder_spec)
    assert m.decoder_spec._asdict() == jm.decoder_spec._asdict()
    assert (m.prior, m.elbo, m.mc_size, m.model_name) == (jm.prior, jm.elbo, jm.mc_size, jm.model_name)


def test_loader_matches_jax(cohorts):
    jc, c = cohorts
    assert (c.train_size, c.val_size, c.test_size, c.latent_dim, c.obs_dim) == (1000, 100, 200, 6, 20)
    assert type(c.roche_config).__module__ == "hybridode_torch.config"
    want, got = jc.get_split("test", 8, 0), c.get_split("test", 8, 0)
    for k in want:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == want[k].shape
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_sim_decoder_apply_rk4_matches_jax(cohorts):
    jc, c = cohorts
    jm, m = _models()
    jparams = j_init_vi(jax.random.PRNGKey(3), jm)
    params = params_from_jax(jparams, device="cpu")
    rng = np.random.RandomState(3)
    z = (np.exp(0.3 * rng.randn(B, 6)) / 10).astype(np.float32)
    actions = np.array(jc.get_split("test", B, 0)["actions"])
    jx, jh = j_decoders.sim_decoder_apply(jparams["decoder"], jm.decoder_spec, jnp.asarray(z), jnp.asarray(actions))
    with torch.no_grad():
        x, h = decoders.sim_decoder_apply(params["decoder"], m.decoder_spec, torch.from_numpy(z),
                                          torch.from_numpy(actions))
    assert bool(torch.isfinite(x).all())
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=RTOL, atol=ATOL)


def test_eval_chunk_matches_jax(cohorts):
    jc, c = cohorts
    jm, m = _models()
    jparams = j_init_vi(jax.random.PRNGKey(7), jm)
    params = params_from_jax(jparams, device="cpu")
    key = jax.random.PRNGKey(11)
    want = j_eval_chunk(jparams, jm, jc.get_split("test", B, 0), T0, MC, jc.expert_dim, key)

    # The noise JAX's _chunk_forward draws: split off the point key, then one key per MC draw.
    mc_keys = jax.random.split(jax.random.split(key)[0], MC)
    eps = np.stack([np.asarray(jax.random.normal(k, (B, 6), jnp.float32)) for k in mc_keys])
    roche_rk4.roche_rk4_trajectory.launches = 0
    got = _eval_chunk(params, m, c.get_split("test", B, 0), T0, c.expert_dim, torch.from_numpy(eps))
    assert roche_rk4.roche_rk4_trajectory.launches == 0  # CPU tensors take the plain path
    for name, g, w in zip(("err_z0", "err_x", "crps_z0", "crps_x"), got, want):
        assert tuple(g.shape) == (B,) and bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=name)


def test_evaluate_prints_the_csv_contract(capsys):
    _, m = _models()
    small = SyntheticCohort.load(COHORT, device="cpu")
    small.test_size = 2 * B  # two chunks of B patients
    params = init_vi(torch.Generator().manual_seed(0), m, device="cpu")
    out = evaluate(params, m, small, batch_size=B, t0=T0, mc_itr=MC, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()[-4:]
    assert [ln.split(",")[0] for ln in lines] == ["rmse_z0", "rmse_x", "cprs_z0", "cprs_x"]
    assert all(len(ln.split(",")) == 3 for ln in lines)
    assert len(out) == 6 and np.all(np.isfinite(out))
    again = evaluate(params, m, small, batch_size=B, t0=T0, mc_itr=MC, generator=torch.Generator().manual_seed(0),
                     verbose=False, device="cpu")
    assert again[0] == out[0] and again[2] == out[2] and again[5] == out[5]  # one seed, one noise draw


def test_entry_points_default_to_cuda():
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
