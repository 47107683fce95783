"""Port vs JAX: the ELBO and its gradients, the KL terms, the forecast loss, Adam, the training loop.

The model is the CLI's hybrid model (per-patient DOPRI5, max_steps=256,
rtol=1e-7, mc_size=100, Exponential prior) on 8 patients of data_s123 for
the losses, and on a small generated cohort (obs 8, as tests/test_cli.py
makes it) for the training loop. JAX draws the ELBO's noise from its keys;
the port is handed exactly those draws.

Tolerances: loss values rtol 1e-4, gradients |g_port - g_jax| <= 2e-3
max|g_jax| + 1e-6 per leaf, both set by the float32 accuracy of the two
DOPRI5 solves (tests/test_torch_dopri5.py: their step sequences differ, their
trajectories agree to ~1e-5). Adam: rtol 1e-5 on the same
gradients, atol 2e-6: optax forms its bias corrections in float32, and
1 - float32(0.999) is off by 1.3e-5 relative, so each of its updates (~lr =
0.01) may differ from PyTorch's (corrections in float64) by ~1.3e-7, ten
steps by ~1.3e-6. Training loop with elbo=False (no noise): curve and final
parameters within rtol 1e-3; the absolute floor of 1e-4 on the parameters
covers Adam's first steps, which move a parameter by ~lr whatever the size
of its gradient, so a gradient near zero can point either way in the two
packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hybridode.cli.common import build_sim_model as j_build_sim_model
from hybridode.config import DataConfig as JDataConfig
from hybridode.config import RocheConfig as JRocheConfig
from hybridode.data import SyntheticCohort as JSyntheticCohort
from hybridode.inference import elbo as j_elbo
from hybridode.inference import init_vi as j_init_vi
from hybridode.inference import load_checkpoint as j_load_checkpoint
from hybridode.inference import param_labels as j_param_labels
from hybridode.inference import variational_training_loop as j_training_loop
from hybridode.models import priors as j_priors
from hybridode_torch.cli.common import build_sim_model
from hybridode_torch.config import DataConfig
from hybridode_torch.convert import params_from_jax, params_to_jax
from hybridode_torch.data import SyntheticCohort
from hybridode_torch.inference import elbo, make_optimizer, train, variational_training_loop
from hybridode_torch.models import priors

COHORT = os.path.join(os.path.dirname(__file__), os.pardir, "data_s123", "datafile_dose_exp.pkl")
B = 8
ADAM_ATOL = 2e-6


@pytest.fixture(scope="module")
def cohorts():
    return JSyntheticCohort.load(COHORT), SyntheticCohort.load(COHORT, device="cpu")


@pytest.fixture(scope="module")
def small_cohort(tmp_path_factory):
    """48 patients (24 train / 8 val / 16 test), obs 8, written by the JAX package."""
    dg = JSyntheticCohort(
        n_sample=48, obs_dim=8, t_max=14, step_size=1, roche_config=JRocheConfig(kel=1),
        output_sigma=0.2, dose_max=10, latent_dim=6, sparsity=0.5, output_sparsity=0.5,
        p_remove=0.5, val_size=8, test_size=16, rng=np.random.RandomState(666),
    )
    dg.generate_data()
    dg.split_sample()
    path = str(tmp_path_factory.mktemp("cohort") / "cohort.pkl")
    dg.save(path)
    return path


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def _jax_noise(key, model, shape):
    """The draws of JAX's sim_loss: eps from k_rep, one eps per MC sample from k_kl."""
    k_rep, k_kl = jax.random.split(key)
    eps = np.array(jax.random.normal(k_rep, shape, jnp.float32))
    eps_kl = np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                       for k in jax.random.split(k_kl, model.mc_size)])
    return torch.from_numpy(eps), torch.from_numpy(eps_kl)


def test_sim_loss_value_and_gradients_match_jax(cohorts):
    jc, c = cohorts
    jm = j_build_sim_model("hybrid", JDataConfig())
    m = build_sim_model("hybrid", DataConfig())
    assert m.decoder_spec.per_sample_control and m.decoder_spec.method == "dopri5" and m.mc_size == 100
    jparams = j_init_vi(jax.random.PRNGKey(3), jm)
    key = jax.random.PRNGKey(5)
    j_val, j_grads = jax.jit(jax.value_and_grad(j_elbo.sim_loss), static_argnums=1)(
        jparams, jm, jc.get_split("train", B, 0), key)

    params = params_from_jax(jparams, device="cpu")
    eps, eps_kl = _jax_noise(key, jm, (B, 6))
    loss = elbo.sim_loss(params, m, c.get_split("train", B, 0), eps=eps, eps_kl=eps_kl)
    loss.backward()
    assert np.isfinite(float(j_val)) and torch.isfinite(loss)
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=1e-4)

    want = dict(_leaves(j_grads))
    for name, p in params.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and (".expert." in name or ".theta_" in name), name
            continue
        g, jg = p.grad.numpy(), want[name]
        assert np.isfinite(g).all() and np.isfinite(jg).all(), name
        assert np.max(np.abs(g - jg)) <= 2e-3 * np.max(np.abs(jg)) + 1e-6, (name, np.max(np.abs(g - jg)))
    assert sum(not p.requires_grad for p in params.parameters()) == 13


def test_sim_loss_draws_from_a_generator_in_a_fixed_order(cohorts):
    _, c = cohorts
    m = build_sim_model("hybrid", DataConfig())
    m = m._replace(decoder_spec=m.decoder_spec._replace(method="rk4", ode_step_size=0.125), mc_size=3)
    params = elbo.init_vi(torch.Generator().manual_seed(0), m, device="cpu")
    batch = c.get_split("train", B, 0)
    gen = torch.Generator().manual_seed(9)
    eps, eps_kl = elbo.draw_noise(m, B, torch.Generator().manual_seed(9), "cpu")
    assert eps.shape == (B, 6) and eps_kl.shape == (3, B, 6)
    with torch.no_grad():
        a = elbo.sim_loss(params, m, batch, gen)
        b = elbo.sim_loss(params, m, batch, eps=eps, eps_kl=eps_kl)
    assert a.item() == b.item()
    assert elbo.draw_noise(m._replace(elbo=False), B, gen, "cpu") == (None, None)
    assert elbo.draw_noise(m._replace(prior=None), B, gen, "cpu")[1] is None


def test_kl_terms_match_jax():
    rng = np.random.RandomState(4)
    mu = (np.abs(rng.randn(B, 6)) * 0.05).astype(np.float32)  # small means: some draws hit the z <= 0 clamp
    log_var = (rng.randn(B, 6) - 5.0).astype(np.float32)
    key = jax.random.PRNGKey(8)
    want = j_elbo.mc_kl(key, jnp.asarray(mu), jnp.asarray(log_var), j_priors.exponential_log_density, 50)
    eps_kl = np.stack([np.asarray(jax.random.normal(k, (B, 6), jnp.float32)) for k in jax.random.split(key, 50)])
    z = mu + eps_kl * np.exp(0.5 * log_var)
    assert (z <= 0).any()
    got = elbo.mc_kl(torch.from_numpy(eps_kl), torch.from_numpy(mu), torch.from_numpy(log_var),
                     priors.exponential_log_density)
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        elbo._analytic_gaussian_kl(torch.from_numpy(mu), torch.from_numpy(log_var)).item(),
        float(j_elbo._analytic_gaussian_kl(jnp.asarray(mu), jnp.asarray(log_var))), rtol=1e-6)


def test_forecast_loss_matches_jax(cohorts):
    jc, c = cohorts
    jm = j_build_sim_model("hybrid", JDataConfig())
    m = build_sim_model("hybrid", DataConfig())
    jparams = j_init_vi(jax.random.PRNGKey(6), jm)
    params = params_from_jax(jparams, device="cpu")
    want = jax.jit(j_elbo.forecast_loss, static_argnums=(1, 3))(jparams, jm, jc.get_split("val", B, 0), 5)
    with torch.no_grad():
        got = elbo.forecast_loss(params, m, c.get_split("val", B, 0), 5)
        num, den = elbo.forecast_loss_terms(params, m, c.get_split("val", B, 0), 5)
    assert np.isfinite(float(want)) and torch.isfinite(got)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    assert got.item() == (num / den).item()


def test_adam_matches_optax_and_leaves_the_expert_frozen():
    jm = j_build_sim_model("hybrid", JDataConfig())
    jparams = j_init_vi(jax.random.PRNGKey(1), jm)
    lr = 0.01
    opt = optax.multi_transform({"train": optax.adam(lr), "freeze": optax.set_to_zero()}, j_param_labels(jparams))
    state = opt.init(jparams)
    params = params_from_jax(jparams, device="cpu")
    expert0 = {k: v.clone() for k, v in params.named_parameters() if ".expert." in k}
    torch_opt = make_optimizer(lr, params)
    rng = np.random.RandomState(2)
    for _ in range(10):
        grads = {k: np.asarray(rng.randn(*np.shape(v)), np.float32) for k, v in _leaves(jparams)}
        j_grads = jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(grads[".".join(str(getattr(q, "key", getattr(q, "idx", q))) for q in path)]),
            jparams)
        updates, state = opt.update(j_grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in params.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(grads[k])
        torch_opt.step()
    got = dict(_leaves(params_to_jax(params)))
    for k, want in _leaves(jparams):
        np.testing.assert_allclose(got[k], want, rtol=1e-5, atol=ADAM_ATOL, err_msg=k)
    for k, p in params.named_parameters():
        if ".expert." in k:
            assert torch.equal(p, expert0[k]) and not p.requires_grad, k
    assert len(expert0) == 13


def test_adam_update_formula_is_pinned():
    """Both optimizers compute lr * m_hat / (sqrt(v_hat) + eps), eps outside the root."""
    rng = np.random.RandomState(3)
    w0 = rng.randn(5).astype(np.float64)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = torch.optim.Adam([p], lr=0.01)
    w, m, v = w0.copy(), np.zeros(5), np.zeros(5)
    for t in range(1, 6):
        g = rng.randn(5) * 1e-6  # small gradients: the placement of eps matters
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        m_hat, v_hat = m / (1 - 0.9**t), v / (1 - 0.999**t)
        w = w - 0.01 * m_hat / (np.sqrt(v_hat) + 1e-8)
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=1e-12, atol=1e-14)
        wrong = w - 0.01 * m_hat / np.sqrt(v_hat + 1e-8)  # eps inside the root
        assert not np.allclose(p.detach().numpy(), wrong, rtol=1e-9, atol=1e-12)


def test_make_optimizer_train_expert_unfreezes():
    m = build_sim_model("hybrid", DataConfig())
    params = elbo.init_vi(torch.Generator().manual_seed(0), m, device="cpu")
    n_frozen = sum(p.numel() for p in params.parameters() if not p.requires_grad)
    n_opt = sum(p.numel() for g in make_optimizer(0.01, params).param_groups for p in g["params"])
    assert n_frozen == 13 and n_opt == sum(p.numel() for p in params.parameters()) - 13
    n_all = sum(p.numel() for g in make_optimizer(0.01, params, train_expert=True).param_groups for p in g["params"])
    assert n_all == sum(p.numel() for p in params.parameters())


def test_training_loop_matches_jax_host_loop(small_cohort, tmp_path):
    """elbo=False (no noise), shuffle=False, forecast validation every 2 of 6 iterations."""
    dc = JDataConfig(obs_dim=8, latent_dim=6)
    jm = j_build_sim_model("hybrid", dc, elbo=False)
    m = build_sim_model("hybrid", DataConfig(obs_dim=8, latent_dim=6), elbo=False)
    jparams = j_init_vi(jax.random.PRNGKey(0), jm)
    params = params_from_jax(jparams, device="cpu")
    kw = dict(niters=6, model=None, batch_size=8, lr=0.01, test_freq=2, shuffle=False, val_criterion="forecast",
              val_t0=5, early_stop=10, verbose=False)
    j_out = j_training_loop(data_generator=JSyntheticCohort.load(small_cohort), params=jparams,
                            key=jax.random.PRNGKey(0), path=str(tmp_path / "jax_"), fused=False,
                            curve_path=str(tmp_path / "jax.csv"), **dict(kw, model=jm))
    out = variational_training_loop(data_generator=SyntheticCohort.load(small_cohort, device="cpu"), params=params,
                                    generator=torch.Generator().manual_seed(0), path=str(tmp_path / "port_"),
                                    curve_path=str(tmp_path / "port.csv"), events_path=str(tmp_path / "ev.jsonl"),
                                    fused=False, **dict(kw, model=m))
    j_curve = np.loadtxt(tmp_path / "jax.csv", delimiter=",").reshape(-1, 3)
    curve = np.loadtxt(tmp_path / "port.csv", delimiter=",").reshape(-1, 3)
    assert curve.shape == (3, 3) and np.isfinite(curve).all()
    np.testing.assert_array_equal(curve[:, 0], [2, 4, 6])
    np.testing.assert_allclose(curve, j_curve, rtol=1e-3)
    np.testing.assert_allclose(out[1], j_out[1], rtol=1e-3)  # best_on_disk

    got = dict(_leaves(params_to_jax(out[0])))
    for k, want in _leaves(j_out[0]):
        np.testing.assert_allclose(got[k], want, rtol=1e-3, atol=1e-4, err_msg=k)
    # The port's checkpoint is the JAX package's format.
    back, itr, best = j_load_checkpoint(str(tmp_path / "port_"), m.model_name)
    assert best == out[1] and itr in (2, 4, 6)
    for k, want in _leaves(back):
        np.testing.assert_array_equal(got[k], want, err_msg=k)


def test_training_loop_rules(cohorts, tmp_path, monkeypatch, capsys):
    """Early stop, the 1e9 of a non-finite validation chunk, and the fallback save when nothing beat the disk.

    The val fold has 100 patients: two chunks of 50 per validation, with scripted losses.
    """
    _, c = cohorts
    m = build_sim_model("hybrid", DataConfig())
    params = elbo.init_vi(torch.Generator().manual_seed(0), m, device="cpu")
    before = {k: v.detach().clone() for k, v in params.named_parameters()}
    val = iter([5.0, 4.0, float("nan"), 7.0, 8.0, 9.0])  # validations: 9, 1e9 + 7, 17
    monkeypatch.setattr(train, "train_step", lambda *a: torch.tensor(1.5))
    monkeypatch.setattr(train, "make_eval_loss", lambda *a: lambda *b: torch.tensor(next(val)))
    out, best, _ = variational_training_loop(niters=20, data_generator=c, model=m, params=params, batch_size=50,
                                             lr=0.01, test_freq=1, generator=torch.Generator().manual_seed(0),
                                             best_on_disk=4.5, early_stop=2, path=str(tmp_path / "m_"),
                                             shuffle=True, curve_path=str(tmp_path / "c.csv"), fused=False)
    lines = capsys.readouterr().out.splitlines()
    # 9 sets the restart's best, the next two do not beat it: early stop after iteration 3.
    assert [ln.split("|")[0].strip() for ln in lines if ln.startswith("Iter")] == ["Iter 0001", "Iter 0002",
                                                                                  "Iter 0003"]
    # Nothing beat the 4.5 on disk: the current parameters are saved with it and reloaded.
    assert best == 4.5 and lines[-1] == "Overall best loss: 4.500000" and lines[-2].startswith("Time: ")
    curve = np.loadtxt(tmp_path / "c.csv", delimiter=",").reshape(-1, 3)
    np.testing.assert_allclose(curve, [[1, 9.0, 1.5], [2, 1e9 + 7.0, 1.5], [3, 17.0, 1.5]])
    assert all(torch.equal(v, before[k]) for k, v in out.named_parameters())


def test_training_loop_checkpoints_improvements_and_reloads_the_best(cohorts, tmp_path, monkeypatch):
    _, c = cohorts
    m = build_sim_model("hybrid", DataConfig())
    params = elbo.init_vi(torch.Generator().manual_seed(0), m, device="cpu")
    vals = iter([3.0, 2.0, 1.0, 5.0, 6.0, 7.0])  # validations: 5, 6, 13

    def step(p, *a):
        with torch.no_grad():
            p["decoder"]["output"]["b"].add_(1.0)  # a visible change per iteration
        return torch.tensor(0.5)

    monkeypatch.setattr(train, "train_step", step)
    monkeypatch.setattr(train, "make_eval_loss", lambda *a: lambda *b: torch.tensor(next(vals)))
    b0 = params["decoder"]["output"]["b"].detach().clone()
    path = str(tmp_path / "m_")
    out, best, _ = variational_training_loop(niters=4, data_generator=c, model=m, params=params, batch_size=50,
                                             lr=0.01, test_freq=1, generator=torch.Generator().manual_seed(0),
                                             early_stop=2, path=path, shuffle=False, verbose=False, fused=False)
    assert best == 5.0  # iteration 1's validation, never beaten
    torch.testing.assert_close(out["decoder"]["output"]["b"], b0 + 1.0)  # reloaded from iteration 1
    assert not out["decoder"]["ode"]["expert"]["kel"].requires_grad


def test_nonfinite_training_loss_ends_the_restart(cohorts, tmp_path, capsys):
    """A budget the Roche solves exhaust (one chunk of 64 trial steps) gives NaN at unreached grid
    points, so a NaN loss: the restart stops, and the current parameters are saved as the fallback."""
    _, c = cohorts
    m = build_sim_model("hybrid", DataConfig(), max_steps=64)
    params = elbo.init_vi(torch.Generator().manual_seed(0), m, device="cpu")
    path = str(tmp_path / "m_")
    out, best, _ = variational_training_loop(niters=3, data_generator=c, model=m, params=params, batch_size=B,
                                             lr=0.01, test_freq=1, generator=torch.Generator().manual_seed(0),
                                             path=path, shuffle=False, events_path=str(tmp_path / "e.jsonl"), fused=False)
    text = capsys.readouterr().out
    assert "non-finite training loss; stopping this restart" in text and "Iter" not in text
    assert best == 1e9 and os.path.exists(path + m.model_name)
    events = [ln for ln in open(tmp_path / "e.jsonl")]
    assert len(events) == 2 and '"step"' in events[0] and '"done"' in events[1]


def test_unported_training_modes_raise(cohorts):
    """Data parallelism over more ranks than the world holds raises JAX's mesh error, on the fused and the host
    loop alike (outside a world there is one)."""
    _, c = cohorts
    m = build_sim_model("hybrid", DataConfig())
    params = elbo.init_vi(torch.Generator().manual_seed(0), m, device="cpu")
    common = dict(niters=1, data_generator=c, model=m, params=params, batch_size=B, lr=0.01, test_freq=1,
                  generator=torch.Generator().manual_seed(0))
    for fused in (True, False, None):
        with pytest.raises(ValueError, match="requested a 2-device 'data' mesh but only 1 devices are available"):
            variational_training_loop(dp_devices=2, fused=fused, **common)


def test_get_mini_batch_matches_jax(cohorts):
    jc, c = cohorts
    want = jc.get_mini_batch("train", B, np.random.RandomState(4))
    got = c.get_mini_batch("train", B, np.random.RandomState(4))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
