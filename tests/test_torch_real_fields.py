"""Port vs JAX for the real track's pieces below the model: dose kernels, fields, elu, NNLS, the cohort.

Inputs come from numpy.random.RandomState; JAX parameters reach the port via
convert.params_from_jax. Tolerances: the dose kernels 1e-6 (one exp per
term, summed in another order); fields and elu, values and vjps (against the
state and every parameter leaf), rtol 1e-5, atol 1e-6 for entries that cancel
to ~0; `nnls2` rtol 1e-5 (float32 sums of 200 products); `nnls` against
scipy.optimize.nnls atol 1e-9 (both float64); the stand-in's arrays equal
bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

from hybridode.data import RealCohort as JRealCohort
from hybridode.data import make_real_standin as j_make_real_standin
from hybridode.ensembles import nnls2 as j_nnls2
from hybridode.fields import CumDoseContext as JCumDoseContext
from hybridode.fields import cumulative_dose as j_cumulative_dose
from hybridode.fields import exp_decay_dose_seq as j_exp_decay_dose_seq
from hybridode.fields import real as j_real
from hybridode.models import nn as j_nn
from hybridode_torch.convert import params_from_jax
from hybridode_torch.data import RealCohort, make_real_standin
from hybridode_torch.ensembles import learn_ensemble_weights, nnls, nnls2
from hybridode_torch.fields import CumDoseContext, cumulative_dose, exp_decay_dose_seq, real
from hybridode_torch.models import nn

DOSE_TOL = 1e-6
RTOL, ATOL = 1e-5, 1e-6
T, B = 12, 5


def _actions(A, seed=0):
    """Sparse non-negative doses on channel 0, dense statics-like values on the others."""
    rng = np.random.RandomState(seed)
    a = rng.randn(T, B, A).astype(np.float32)
    a[..., 0] = np.where(rng.rand(T, B) < 0.3, rng.rand(T, B), 0.0)
    return a


@pytest.mark.parametrize("A", [1, 12])
@pytest.mark.parametrize("t", [0.0, 2.5, 7.25, 12.0, 15.5])
def test_exp_decay_dose_seq(A, t):
    a = _actions(A)
    want = j_exp_decay_dose_seq(jnp.float32(t), JCumDoseContext(jnp.asarray(a)), jnp.float32(0.3))
    got = exp_decay_dose_seq(torch.tensor(t), CumDoseContext(torch.from_numpy(a)), torch.tensor(0.3))
    assert got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=DOSE_TOL, atol=DOSE_TOL)


@pytest.mark.parametrize("t", [0.0, 3.7, 11.0, 11.9, 12.0, 15.5, -0.5])
def test_cumulative_dose(t):
    """Fractional t, the last index, t at T and beyond it (zero), and t before the first step."""
    a = _actions(3)
    want = j_cumulative_dose(jnp.float32(t), JCumDoseContext(jnp.asarray(a)))
    got = cumulative_dose(torch.tensor(t), CumDoseContext(torch.from_numpy(a)))
    assert got.shape == (B, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=DOSE_TOL, atol=DOSE_TOL)
    if t >= T:
        assert not got.any()


def test_dose_kernels_take_one_time_per_leading_slice():
    """A (N, 1, 1) time, as the per-interval solve gives it, equals N scalar calls (JAX's vmap)."""
    a = torch.from_numpy(_actions(12, seed=2))
    ts = torch.tensor([0.5, 3.0, 6.5, 12.0])
    ctx = CumDoseContext(a)
    seq = exp_decay_dose_seq(ts[:, None, None], ctx, torch.tensor(0.4))
    cum = cumulative_dose(ts[:, None, None], ctx)
    assert seq.shape == (4, B) and cum.shape == (4, B, 12)
    for i, t in enumerate(ts):
        torch.testing.assert_close(seq[i], exp_decay_dose_seq(t, ctx, torch.tensor(0.4)), rtol=0, atol=0)
        torch.testing.assert_close(cum[i], cumulative_dose(t, ctx), rtol=0, atol=0)
    with pytest.raises(ValueError, match=r"\(B, 1\)"):
        cumulative_dose(torch.zeros(B), ctx)


def _field_case(name, latent, seed=0):
    """(JAX field, port field, JAX params, y, actions) for one of the three real fields."""
    key = jax.random.PRNGKey(seed)
    A = 3
    if name == "roche":
        jp = j_real.init_roche_real_field(key, latent, 7)
        jp.update(k_immunity=jnp.float32(0.8), kel=jnp.float32(0.35), kel2=jnp.float32(0.15))  # not the init
        fields = j_real.roche_real_field, real.roche_real_field
    elif name == "neural":
        jp = j_real.init_neural_real_field(key, latent, A, 7)
        fields = j_real.neural_real_field, real.neural_real_field
    else:
        jp = j_real.init_neural_real_2nd_field(key, latent, A, 7)
        fields = j_real.neural_real_2nd_field, real.neural_real_2nd_field
    rng = np.random.RandomState(seed + 1)
    y = (rng.randn(B, latent) * 0.5).astype(np.float32)
    return fields, jp, y, _actions(A, seed)


@pytest.mark.parametrize("name,latent", [("roche", 4), ("roche", 8), ("neural", 4), ("neural", 6), ("2nd", 4),
                                         ("2nd", 6)])
def test_real_fields_values_and_vjp(name, latent):
    (j_field, field), jp, y, a = _field_case(name, latent)
    t = 5.5
    jctx = JCumDoseContext(jnp.asarray(a))
    want, vjp = jax.vjp(lambda p, y_: j_field(jnp.float32(t), y_, (p, jctx)), jp, jnp.asarray(y))
    cot = np.random.RandomState(9).randn(*want.shape).astype(np.float32)
    j_gp, j_gy = vjp(jnp.asarray(cot))

    params = params_from_jax(jp, device="cpu")
    yt = torch.from_numpy(y).requires_grad_(True)
    got = field(torch.tensor(t), yt, (params, CumDoseContext(torch.from_numpy(a))))
    assert got.shape == (B, latent)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)

    names = [k for k, _ in params.named_parameters()]
    grads = torch.autograd.grad(got, [yt] + list(params.parameters()), torch.from_numpy(cot))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(j_gy), rtol=RTOL, atol=ATOL)
    j_leaves = dict(_leaves(j_gp))
    assert set(names) == set(j_leaves)
    for k, g in zip(names, grads[1:]):
        assert g.shape == j_leaves[k].shape, k
        np.testing.assert_allclose(g.numpy(), j_leaves[k], rtol=RTOL, atol=ATOL, err_msg=k)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def test_roche_real_field_parameters():
    """0-d trainable rate constants, the GRU remainder only past 4 latents, nothing frozen."""
    gen = torch.Generator().manual_seed(0)
    p4 = real.init_roche_real_field(gen, 4, 48, device="cpu")
    p20 = real.init_roche_real_field(gen, 20, 48, device="cpu")
    for k in ("k_immunity", "kel", "kel2"):
        assert p4[k].shape == () and p4[k].requires_grad
    assert p4["dx1_net"][0]["w"].shape == (3, 48) and p4["dx1_net"][1]["w"].shape == (48, 1)
    assert "lin_hr" not in p4 and p20["lin_hh"]["w"].shape == (16, 16) and "b" not in p20["lin_hh"]
    assert all(p.requires_grad for p in p20.parameters())


def test_elu_value_and_gradient():
    x = np.random.RandomState(0).randn(64).astype(np.float32) * 3
    want, vjp = jax.vjp(j_nn.elu, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = nn.elu(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    (g,) = torch.autograd.grad(got, xt, torch.ones(64))
    np.testing.assert_allclose(g.numpy(), np.asarray(vjp(jnp.ones(64))[0]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["feasible", "one_negative", "degenerate"])
def test_nnls2_matches_jax(case):
    rng = np.random.RandomState(3)
    a1, a2 = rng.randn(6, 200).astype(np.float32), rng.randn(6, 200).astype(np.float32)
    b = (0.7 * a1 + 0.4 * a2 + 0.1 * rng.randn(6, 200)).astype(np.float32)
    if case == "one_negative":
        b = (0.9 * a1 - 0.5 * a2).astype(np.float32)
    elif case == "degenerate":
        a2 = a1.copy()  # det = 0: the single-variable candidates decide
    want = j_nnls2(jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(b))
    got = nnls2(torch.from_numpy(a1), torch.from_numpy(a2), torch.from_numpy(b))
    for g, w in zip(got, want):
        assert (g.numpy() >= 0).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n", [2, 5])
def test_nnls_matches_scipy(n):
    rng = np.random.RandomState(n)
    A = rng.randn(30, n)
    b = A @ np.where(rng.rand(n) < 0.5, -1.0, 1.0) + 0.1 * rng.randn(30)  # some weights pinned at 0
    x, r = nnls(A, b)
    x_ref, r_ref = scipy.optimize.nnls(A, b)
    np.testing.assert_allclose(x, x_ref, atol=1e-9)
    np.testing.assert_allclose(r, r_ref, atol=1e-9)


def test_learn_ensemble_weights_zero_before_t0():
    rng = np.random.RandomState(1)
    x, e, m = (torch.from_numpy(rng.randn(8, 4, 3).astype(np.float32)) for _ in range(3))
    we, wm = learn_ensemble_weights(x, e, m, t0=3)
    assert we.shape == (8, 1, 3) and wm.shape == (8, 1, 3)
    assert not we[:3].any() and not wm[:3].any()
    w1, w2 = nnls2(e.reshape(8, 12), m.reshape(8, 12), x.reshape(8, 12))
    torch.testing.assert_close(we[3:, 0, 0], w1[3:])
    torch.testing.assert_close(wm[3:, 0, 0], w2[3:])


STANDIN = dict(n_sample=40, t_max=14, obs_dim=5, static_dim=3, latent_dim=4)
FILES = ("array_xt5.pkl", "array_xt_mask5.pkl", "array_at5.pkl", "array_x_constant.pkl")


def test_make_real_standin_writes_the_jax_arrays(tmp_path):
    j_make_real_standin(str(tmp_path / "jax"), **STANDIN)
    make_real_standin(str(tmp_path / "port"), **STANDIN)
    for name in FILES:
        want = np.load(tmp_path / "jax" / name, allow_pickle=True)
        got = np.load(tmp_path / "port" / name, allow_pickle=True)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape, name
        assert np.array_equal(got, want), name
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "port" / name).read_bytes(), name


def test_real_cohort_folds_match_jax(tmp_path, capsys):
    make_real_standin(str(tmp_path), **STANDIN)
    jc = JRealCohort(str(tmp_path), val_size=8, test_size=16)
    c = RealCohort(str(tmp_path), val_size=8, test_size=16, device="cpu")
    jc.split_sample()
    c.split_sample()
    assert (c.t_max, c.step_size, c.obs_dim, c.action_dim, c.static_dim, c.train_size) == (14, 1.0, 5, 1, 3, 16)
    for fold in ("train", "val", "test"):
        for k, v in getattr(jc, f"data_{fold}").items():
            got = getattr(c, f"data_{fold}")[k]
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(v), err_msg=f"{fold}.{k}")
    assert not c.data_train["latents"].any() and c.data_train["latents"].shape == (14, 16, 10)
    np.testing.assert_array_equal(c.data_test["statics"][0].numpy(), c.data_test["statics"][-1].numpy())

    for batch in ((c.get_split("val", 4, 1), jc.get_split("val", 4, 1)),
                  (c.get_mini_batch("train", 5, np.random.RandomState(2)),
                   jc.get_mini_batch("train", 5, np.random.RandomState(2)))):
        for k in batch[1]:
            np.testing.assert_array_equal(batch[0][k].numpy(), np.asarray(batch[1][k]), err_msg=k)

    # The reference's real.sh asks for more patients than the pool holds: clamp, with a message.
    c.set_train_size(100)
    jc.set_train_size(100)
    out = capsys.readouterr().out
    assert out.count("set_train_size: clamping 100 -> 16 (pool size)") == 2
    assert c.train_size == jc.train_size == 16 and c.data_train["measurements"].shape[1] == 16
    c.set_train_size(10)
    c.set_val_size(3)
    assert c.train_size == 10 and c.data_train["masks"].shape[1] == 10 and c.data_val["actions"].shape[1] == 3
    with pytest.raises(ValueError):
        c.set_train_size(0)


def test_real_cohort_reads_the_repo_cohort_without_unpickling_jax():
    """data_real/ holds the cohort at its real shape; its pickles name only numpy."""
    path = os.path.join(os.path.dirname(__file__), os.pardir, "data_real")
    c = RealCohort(path, device="cpu")
    assert (c.t_max, c.n_sample, c.obs_dim, c.action_dim, c.static_dim) == (97, 2097, 28, 1, 11)
    assert c.train_size == 997
