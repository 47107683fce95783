"""Port vs JAX: the flow posterior's evaluation chunk, the horizon chunk, the ensemble chunk and their aggregates.

Each chunk runs on 8 test patients of data_s123 with RK4 decoders at
ode_step_size=0.125, mc_itr=4, t0=5: the hybrid flow model (latent 6, 4
planar flows), the hybrid sim model, and the ensemble of the expert (latent 4)
and the neural model (latent 6). The port is handed the exact draws JAX makes
inside its `_chunk_forward` (hybridode/eval/metrics.py:93-102: the point key
split off first, then one key per MC draw; an ensemble splits its key into one
per member). Tolerance rtol=2e-3, atol=5e-4, as tests/test_torch_eval.py holds
`_eval_chunk`: float32 rounding of two evaluation orders of the RK4 solve.

The aggregates (`evaluate_horizon`, `evaluate_ensemble`,
`evaluate_ensemble_horizon`) run the JAX functions on the port's own chunk
outputs (recorded, then replayed in place of JAX's jitted chunk), on two
chunks with one patient observed nowhere past t0: the same per-step vectors,
the same dropped NaN patient and the same CSV, equal to 1e-6.
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
from hybridode.eval import metrics as j_metrics
from hybridode.inference import init_vi as j_init_vi
from hybridode_torch.cli.common import build_sim_model
from hybridode_torch.config import DataConfig
from hybridode_torch.convert import params_from_jax
from hybridode_torch.data import SyntheticCohort
from hybridode_torch.eval import evaluate_ensemble, evaluate_ensemble_horizon, evaluate_horizon, metrics
from hybridode_torch.inference import elbo, init_vi
from hybridode_torch.ops import roche_rk4

RTOL, ATOL = 2e-3, 5e-4
COHORT = os.path.join(os.path.dirname(__file__), os.pardir, "data_s123", "datafile_dose_exp.pkl")
T0, MC, B = 5, 4, 8


@pytest.fixture(scope="module")
def cohorts():
    return JSyntheticCohort.load(COHORT), SyntheticCohort.load(COHORT, device="cpu")


def _models(method, flow=False):
    kw = dict(ode_method="rk4", flow=flow)
    jm = j_build_sim_model(method, JDataConfig(), **kw)
    m = build_sim_model(method, DataConfig(), **kw)
    return (jm._replace(decoder_spec=jm.decoder_spec._replace(ode_step_size=0.125)),
            m._replace(decoder_spec=m.decoder_spec._replace(ode_step_size=0.125)))


def _pair(method, seed, flow=False):
    jm, m = _models(method, flow)
    jparams = j_init_vi(jax.random.PRNGKey(seed), jm)
    return jm, jparams, m, params_from_jax(jparams, device="cpu")


def _jax_chunk_noise(key, model):
    """(eps (MC, B, D), eps_point (B, D) or None): the draws of JAX's _chunk_forward under `key`."""
    key, k_point = jax.random.split(key)
    D = model.encoder_spec.output_dim
    eps = np.stack([np.array(jax.random.normal(k, (B, D), jnp.float32)) for k in jax.random.split(key, MC)])
    point = np.array(jax.random.normal(k_point, (B, D), jnp.float32)) if model.kind == "flow" else None
    return torch.from_numpy(eps), None if point is None else torch.from_numpy(point)


def _assert_close(got, want, names, shape):
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == shape and bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=name)


def _counting_decodes(monkeypatch):
    calls = []

    def counting_decode(*args):
        calls.append(args[2].shape[0])
        return elbo.decode(*args)

    monkeypatch.setattr(metrics, "decode", counting_decode)
    return calls


def test_eval_chunk_of_the_flow_posterior_matches_jax(cohorts, monkeypatch):
    jc, c = cohorts
    jm, jparams, m, params = _pair("hybrid", 7, flow=True)
    key = jax.random.PRNGKey(11)
    want = jax.jit(j_metrics._eval_chunk, static_argnums=(1, 3, 4, 5))(jparams, jm, jc.get_split("test", B, 0), T0,
                                                                       MC, jc.expert_dim, key)
    calls = _counting_decodes(monkeypatch)
    roche_rk4.roche_rk4_trajectory.launches = 0
    got = metrics._eval_chunk(params, m, c.get_split("test", B, 0), T0, c.expert_dim, *_jax_chunk_noise(key, m))
    assert calls == [(MC + 1) * B]  # the point and the MC flow samples in one decode
    assert roche_rk4.roche_rk4_trajectory.launches == 0  # CPU tensors take the plain path
    _assert_close(got, want, ("err_z0", "err_x", "crps_z0", "crps_x"), (B,))


@pytest.mark.parametrize("flow", [False, True], ids=["sim", "flow"])
def test_horizon_chunk_matches_jax(cohorts, flow):
    jc, c = cohorts
    jm, jparams, m, params = _pair("hybrid", 8, flow=flow)
    key = jax.random.PRNGKey(12)
    want = jax.jit(j_metrics._horizon_chunk, static_argnums=(1, 3, 4))(jparams, jm, jc.get_split("test", B, 0), T0,
                                                                       MC, key)
    got = metrics._horizon_chunk(params, m, c.get_split("test", B, 0), T0, *_jax_chunk_noise(key, m))
    _assert_close(got, want, ("err_x", "crps_x"), (15 - T0, B))


@pytest.mark.parametrize("horizon", [False, True], ids=["point", "horizon"])
def test_ensemble_chunk_matches_jax(cohorts, monkeypatch, horizon):
    jc, c = cohorts
    jm_e, jp_e, m_e, p_e = _pair("expert", 9)
    jm_m, jp_m, m_m, p_m = _pair("neural", 10)
    rng = np.random.RandomState(3)
    w_e, w_m = (rng.rand(15, 1, 20).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(13)
    want = jax.jit(j_metrics._ensemble_chunk, static_argnums=(1, 3, 5, 6, 7, 11))(
        jp_e, jm_e, jp_m, jm_m, jc.get_split("test", B, 0), T0, MC, jc.expert_dim, jnp.asarray(w_e), jnp.asarray(w_m),
        key, horizon)
    k1, k2 = jax.random.split(key)
    calls = _counting_decodes(monkeypatch)
    got = metrics._ensemble_chunk(p_e, m_e, p_m, m_m, c.get_split("test", B, 0), T0, c.expert_dim,
                                  torch.from_numpy(w_e), torch.from_numpy(w_m), _jax_chunk_noise(k1, m_e),
                                  _jax_chunk_noise(k2, m_m), horizon=horizon)
    assert calls == [(MC + 1) * B, (MC + 1) * B]  # one decode per member
    if horizon:
        _assert_close(got, want, ("err_x", "crps_x"), (15 - T0, B))
    else:
        _assert_close(got, want, ("err_z0", "err_x", "crps_z0", "crps_x"), (B,))


def test_chunk_noise_is_drawn_in_the_documented_order():
    _, m_flow = _models("hybrid", flow=True)
    _, m_sim = _models("hybrid")
    gen = torch.Generator().manual_seed(4)
    eps, point = metrics.draw_chunk_noise(m_flow, MC, B, gen, "cpu")
    ref = torch.Generator().manual_seed(4)
    torch.testing.assert_close(point, torch.randn((B, 6), generator=ref), rtol=0, atol=0)  # the flow's point first
    torch.testing.assert_close(eps, torch.randn((MC, B, 6), generator=ref), rtol=0, atol=0)
    eps, point = metrics.draw_chunk_noise(m_sim, MC, B, gen, "cpu")
    assert point is None  # the sim posterior's point is its mean
    torch.testing.assert_close(eps, torch.randn((MC, B, 6), generator=ref), rtol=0, atol=0)


@pytest.fixture(scope="module")
def two_chunks():
    """16 test patients (two chunks of B); patient 3 is observed nowhere past t0 (its err_x is NaN)."""
    c = SyntheticCohort.load(COHORT, device="cpu")
    c.test_size = 2 * B
    c.data_test = {k: v[:, : 2 * B].clone() for k, v in c.data_test.items()}
    c.data_test["masks"][T0:, 3] = 0.0
    return c


def _replayed(monkeypatch, name):
    """Record the port's chunk outputs; -> (records, a stand-in for JAX's chunk that replays them)."""
    records, original = [], getattr(metrics, name)

    def record(*args, **kw):
        out = original(*args, **kw)
        records.append([o.numpy() for o in out])
        return out

    monkeypatch.setattr(metrics, name, record)
    replay = iter(records)
    return records, lambda *args, **kw: next(replay)


@pytest.mark.parametrize("flow", [False, True], ids=["sim", "flow"])
def test_evaluate_horizon_aggregates_as_jax(two_chunks, monkeypatch, flow):
    _, m = _models("hybrid", flow)
    params = init_vi(torch.Generator().manual_seed(0), m, device="cpu")
    records, replay = _replayed(monkeypatch, "_horizon_chunk")
    np.random.seed(0)
    got = evaluate_horizon(params, m, two_chunks, B, T0, mc_itr=MC, generator=torch.Generator().manual_seed(1),
                           device="cpu")
    assert len(records) == 2 and np.isnan(records[0][0][:, 3]).all()
    monkeypatch.setattr(j_metrics, "_horizon_chunk", replay)
    np.random.seed(0)
    want = j_metrics.evaluate_horizon(None, None, two_chunks, B, T0, mc_itr=MC)
    assert sorted(got) == sorted(want) == ["cprs_x", "cprs_x_sd", "rmse_x", "rmse_x_sd"]
    for k in want:
        assert got[k].shape == (15 - T0,) and np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)

    # The noise: each chunk draws its own from the one generator, in order.
    monkeypatch.undo()
    gen = torch.Generator().manual_seed(1)
    for chunk, rec in enumerate(records):
        noise = metrics.draw_chunk_noise(m, MC, B, gen, "cpu")
        out = metrics._horizon_chunk(params, m, two_chunks.get_split("test", B, chunk), T0, *noise)
        for o, r in zip(out, rec):
            np.testing.assert_array_equal(o.numpy(), r)


@pytest.mark.parametrize("horizon", [False, True], ids=["point", "horizon"])
def test_evaluate_ensemble_aggregates_as_jax(two_chunks, monkeypatch, capsys, horizon):
    _, m_e = _models("expert")
    _, m_m = _models("neural")
    p_e = init_vi(torch.Generator().manual_seed(2), m_e, device="cpu")
    p_m = init_vi(torch.Generator().manual_seed(3), m_m, device="cpu")
    w = torch.from_numpy(np.random.RandomState(4).rand(15, 1, 20).astype(np.float32))
    records, replay = _replayed(monkeypatch, "_ensemble_chunk")
    kw = dict(mc_itr=MC, weight_expert=w, weight_ml=1.0 - w)
    fn, j_fn = ((evaluate_ensemble_horizon, j_metrics.evaluate_ensemble_horizon) if horizon
                else (evaluate_ensemble, j_metrics.evaluate_ensemble))
    np.random.seed(0)
    got = fn(p_e, m_e, p_m, m_m, two_chunks, B, T0, generator=torch.Generator().manual_seed(1), device="cpu", **kw)
    port_out = capsys.readouterr().out
    assert len(records) == 2
    monkeypatch.setattr(j_metrics, "_ensemble_chunk", replay)
    np.random.seed(0)
    want = j_fn(None, None, None, None, two_chunks, B, T0, **dict(kw, weight_expert=w.numpy(),
                                                                    weight_ml=1.0 - w.numpy()))
    if horizon:
        assert np.isnan(records[0][0][:, 3]).all() and sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == (15 - T0,) and np.isfinite(got[k]).all(), k
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    else:
        assert np.isnan(records[0][1][3]) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-6)
        lines = port_out.strip().splitlines()
        assert [ln.split(",")[0] for ln in lines] == ["rmse_z0", "rmse_x", "cprs_z0", "cprs_x"]
        assert lines == capsys.readouterr().out.strip().splitlines()  # the JAX package's CSV, digit for digit
