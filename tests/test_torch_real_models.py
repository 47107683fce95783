"""Port vs JAX for the real track's models: encoder, ODE decoder (both ranks), benchmarks, parameter trees.

Small widths (obs 5, one dose channel, 2 statics, latent 6 or 4 for the
expert, field hidden 7, t_max 12, t0 4; the rank-3 decode needs t0 <= 1 and
takes t0 1). JAX parameters reach the port via convert.params_from_jax.
Tolerances: the encoder and the benchmarks rtol 1e-5, atol 1e-6 (float32
transcendentals may differ by an ulp); the ODE decodes rtol 1e-4, atol 1e-5
(9 grid points of a fixed-step solve carry those ulps along). Parameter
trees round-trip bit for bit at the full width of data_real/.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridode.cli.common import build_real_model as j_build_real_model
from hybridode.data import RealCohort as JRealCohort
from hybridode.inference import elbo as j_elbo
from hybridode.inference import init_vi as j_init_vi
from hybridode.inference import load_checkpoint as j_load_checkpoint
from hybridode.inference import save_checkpoint as j_save_checkpoint
from hybridode.models import decoders as j_decoders
from hybridode.models import encoders as j_encoders
from hybridode_torch.cli.common import build_real_model, build_sim_model
from hybridode_torch.config import DataConfig
from hybridode_torch.convert import params_from_jax, params_to_jax
from hybridode_torch.data import RealCohort
from hybridode_torch.inference import init_vi, load_checkpoint, make_optimizer, save_checkpoint
from hybridode_torch.inference.elbo import decode, encode, real_loss
from hybridode_torch.models import decoders, encoders

OBS, A, S, T, B, HID = 5, 1, 2, 12, 4, 7
RTOL, ATOL = 1e-5, 1e-6
ODE_RTOL, ODE_ATOL = 1e-4, 1e-5
METHODS = ("neural", "hybrid", "expert", "2nd", "tlstm", "gruode")


def _inputs(latent, seed=0, T_init=None):
    rng = np.random.RandomState(seed)
    actions = np.where(rng.rand(T, B, A) < 0.3, rng.rand(T, B, A), 0.0).astype(np.float32)
    statics = np.broadcast_to(rng.randn(1, B, S), (T, B, S)).astype(np.float32)
    shape = (B, latent) if T_init is None else (T_init, B, latent)
    init = (np.abs(rng.randn(*shape)) * 0.3).astype(np.float32)
    return init, actions, statics


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("output_all", [False, True])
def test_encoder_lstm_real_apply(reverse, output_all):
    spec = j_encoders.EncoderLSTMRealSpec(OBS + A + S + 1, 9, 6, output_all=output_all, reverse=reverse)
    jp = j_encoders.init_encoder_lstm_real(jax.random.PRNGKey(1), spec)
    rng = np.random.RandomState(2)
    x = rng.randn(6, B, OBS).astype(np.float32)
    a = rng.randn(6, B, A + S).astype(np.float32)
    m = (rng.rand(6, B, OBS) < 0.5).astype(np.float32)
    want = j_encoders.encoder_lstm_real_apply(jp, spec, jnp.asarray(x), jnp.asarray(a), jnp.asarray(m))
    got = encoders.encoder_lstm_real_apply(params_from_jax(jp, device="cpu"), encoders.EncoderLSTMRealSpec(*spec),
                                           _t(x), _t(a), _t(m))
    for g, w in zip(got, want):
        assert g.shape == ((6, B, 6) if output_all else (B, 6))
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def _decoder_specs(ode_type, method, div, t0=4):
    latent = 4 if ode_type == "expert" else 6
    kw = dict(t_max=T, step_size=1.0, t0=t0, method=method, ode_step_size=1.0 / div, ode_type=ode_type)
    jspec = j_decoders.RealDecoderSpec(OBS, latent, A, S, HID, **kw)
    return jspec, decoders.RealDecoderSpec(*jspec), latent


@pytest.mark.parametrize("div", [1, 2])
@pytest.mark.parametrize("method", ["explicit_adams", "rk4", "midpoint"])
@pytest.mark.parametrize("ode_type", ["neural", "2nd", "hybrid", "expert"])
def test_real_decoder_rank2(ode_type, method, div):
    jspec, spec, latent = _decoder_specs(ode_type, method, div)
    jp = j_decoders.init_real_decoder(jax.random.PRNGKey(3), jspec)
    init, actions, statics = _inputs(latent, seed=4)
    want = jax.jit(j_decoders.real_decoder_apply, static_argnums=1)(jp, jspec, init, actions, statics)
    got = decoders.real_decoder_apply(params_from_jax(jp, device="cpu"), spec, _t(init), _t(actions), _t(statics))
    assert got[0].shape == (T - 4, B, OBS) and got[1].shape == (T - 4 + 1, B, latent)
    for g, w in zip(got, want):
        assert np.isfinite(np.asarray(w)).all()
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=ODE_RTOL, atol=ODE_ATOL)


@pytest.mark.parametrize("method,div", [("explicit_adams", 1), ("rk4", 2)])
def test_real_decoder_rank3_hybrid(method, div):
    """One 2-point solve per interval from init[i], a zero row first and x_hat[0] = 0."""
    jspec, spec, latent = _decoder_specs("hybrid", method, div, t0=1)
    jp = j_decoders.init_real_decoder(jax.random.PRNGKey(5), jspec)
    init, actions, statics = _inputs(latent, seed=6, T_init=T - 1)
    want = jax.jit(j_decoders.real_decoder_apply, static_argnums=1)(jp, jspec, init, actions, statics)
    got = decoders.real_decoder_apply(params_from_jax(jp, device="cpu"), spec, _t(init), _t(actions), _t(statics))
    assert got[0].shape == (T - 1, B, OBS) and got[1].shape == (T, B, latent)
    assert not got[0][0].any() and not got[1][0].any()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=ODE_RTOL, atol=ODE_ATOL)
    with pytest.raises(NotImplementedError, match="rank-3"):
        decoders.real_decoder_apply(params_from_jax(jp, device="cpu"), spec._replace(method="dopri5"), _t(init),
                                    _t(actions), _t(statics))


@pytest.mark.parametrize("ode_type", ["tlstm", "gruode"])
def test_real_benchmark_apply(ode_type):
    jspec = j_decoders.RealBenchmarkSpec(OBS, 6, A, S, HID, t_max=T, step_size=1.0, t0=4, ode_type=ode_type)
    jp = j_decoders.init_real_benchmark(jax.random.PRNGKey(7), jspec)
    init, actions, statics = _inputs(6, seed=8)
    want = j_decoders.real_benchmark_apply(jp, jspec, jnp.asarray(init), jnp.asarray(actions), jnp.asarray(statics))
    got = decoders.real_benchmark_apply(params_from_jax(jp, device="cpu"), decoders.RealBenchmarkSpec(*jspec),
                                        _t(init), _t(actions), _t(statics))
    assert got[0].shape == (T - 4, B, OBS) and got[1].shape == (T - 4, B, 6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_gru_ode_cell_returns_dh_and_keeps_the_state():
    jspec = j_decoders.RealBenchmarkSpec(OBS, 6, A, S, HID, t_max=T, step_size=1.0, ode_type="gruode")
    jp = j_decoders.init_real_benchmark(jax.random.PRNGKey(9), jspec)
    rng = np.random.RandomState(1)
    h, a = rng.randn(B, 6).astype(np.float32), rng.randn(B, 2).astype(np.float32)
    want = j_decoders.gru_ode_cell(jp, jnp.asarray(a), jnp.asarray(h))
    got = decoders.gru_ode_cell(params_from_jax(jp, device="cpu"), _t(a), _t(h))
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]), rtol=RTOL, atol=ATOL)
    assert torch.equal(got[1], _t(h))


def _full_width(method):
    """build_real_model on data_real/'s widths (obs 28, 1 dose channel, 11 statics, T 97), in both packages."""
    eod = 4 if method == "expert" else 20
    args = (method, 28, 1, 11, 97, 1.0)
    return j_build_real_model(*args, encoder_output_dim=eod), build_real_model(*args, encoder_output_dim=eod)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


@pytest.mark.parametrize("method", METHODS)
def test_build_real_model_and_init_match_jax_at_full_width(method):
    jm, m = _full_width(method)
    assert m.kind == "real" and not m.elbo and m.t0 == 24 and not m.weight
    assert tuple(m.encoder_spec) == tuple(jm.encoder_spec) and tuple(m.decoder_spec) == tuple(jm.decoder_spec)
    assert m.model_name == jm.model_name == f"VI_LSTMReal_DecoderReal_{method}.pkl"
    assert m.encoder_spec.input_dim == 41 and m.encoder_spec.hidden_dim == 49
    assert m.decoder_spec.hidden_dim == 48 and m.decoder_spec.ts.shape == ((74,) if method in METHODS[:4] else (73,))
    want = dict(_leaves(j_init_vi(jax.random.PRNGKey(0), jm)))
    got = dict(init_vi(torch.Generator().manual_seed(0), m, device="cpu").named_parameters())
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape and got[k].dtype == torch.float32 and got[k].requires_grad, k


@pytest.mark.parametrize("method", ["hybrid", "expert", "gruode"])
def test_real_trees_round_trip_and_checkpoints(method, tmp_path):
    """0-d rate constants and non-square weights (dx1: 3 -> 48 -> 1) cross both ways bit for bit."""
    jm, m = _full_width(method)
    jparams = j_init_vi(jax.random.PRNGKey(2), jm)
    params = params_from_jax(jparams, device="cpu")
    got, want = dict(_leaves(params_to_jax(params))), dict(_leaves(jparams))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if method != "gruode":
        ode = params["decoder"]["ode"]
        assert ode["kel"].shape == () and got["decoder.ode.kel2"].shape == ()
        assert ode["dx1_net"][0]["w"].shape == (3, 48) and ode["dx1_net"][1]["w"].shape == (48, 1)
    assert all(p.requires_grad for p in params.parameters())

    j_save_checkpoint(str(tmp_path / "jax_"), jm.model_name, jparams, itr=7, best_loss=3.5)
    loaded, itr, best = load_checkpoint(str(tmp_path / "jax_"), m.model_name, device="cpu")
    assert (itr, best) == (7, 3.5)
    save_checkpoint(str(tmp_path / "port_"), m.model_name, loaded, itr=8, best_loss=2.5)
    back, itr, best = j_load_checkpoint(str(tmp_path / "port_"), jm.model_name)
    assert (itr, best) == (8, 2.5)
    for k, w in _leaves(back):
        assert w.shape == want[k].shape and w.dtype == want[k].dtype, k
        np.testing.assert_array_equal(w, want[k], err_msg=k)


@pytest.mark.parametrize("method", ["hybrid", "expert"])
def test_adam_trains_every_real_leaf_including_the_rate_constants(method):
    _, m = _full_width(method)
    params = init_vi(torch.Generator().manual_seed(0), m, device="cpu")
    opt = make_optimizer(0.01, params, train_expert=True)
    in_adam = {id(p) for g in opt.param_groups for p in g["params"]}
    names = dict(params.named_parameters())
    assert in_adam == {id(p) for p in names.values()}
    for k in ("k_immunity", "kel", "kel2"):
        p = names[f"decoder.ode.{k}"]
        assert p.shape == () and id(p) in in_adam
    before = {k: v.detach().clone() for k, v in names.items()}
    for p in params.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    assert all(not torch.equal(v, before[k]) for k, v in names.items())  # Adam's first step moves every leaf by lr


def test_flow_kind_is_refused():
    """`kind="flow"` is no longer refused: `init_vi`, `encode` and `decode` run the flow posterior (LHM-NF)."""
    m = build_sim_model("hybrid", DataConfig(obs_dim=OBS, latent_dim=6), flow=True, ode_method="rk4")
    m = m._replace(decoder_spec=m.decoder_spec._replace(ode_step_size=0.125))
    assert m.kind == "flow"
    params = init_vi(torch.Generator().manual_seed(0), m, device="cpu")
    assert {k.split(".")[1] for k, _ in params.named_parameters() if k.startswith("encoder.")} == {
        "lstm", "lin", "log_var", "amor_u", "amor_w", "amor_b"}
    rng = np.random.RandomState(0)
    x, a = _t(rng.randn(15, B, OBS).astype(np.float32)), torch.zeros(15, B, A)
    a[2] = 5.0  # one bolus a patient
    with torch.no_grad():
        out = encode(params, m, x, a, torch.ones_like(x))
        assert [tuple(o.shape) for o in out] == [(B, 6), (B, 6), (B, 4, 6, 1), (B, 4, 1, 6), (B, 4, 1, 1)]
        z = encoders.planar_reparameterize(out, 4, _t(rng.randn(B, 6).astype(np.float32)))[2]
        x_hat, _ = decode(params, m, z, {"actions": a})
    assert x_hat.shape == (15, B, OBS) and bool(torch.isfinite(x_hat).all())


def test_cli_default_hybrid_solve_amplifies_rounding_at_init():
    """The hybrid decode at the CLI's one explicit-Adams step an hour is unstable at init, in both packages.

    The GRU remainder decays at a rate -(1 - z) near -0.5 at init, outside AB4's
    stability interval [-0.3, 0] at dt = 1 and inside it at dt = 0.5. On 8
    patients of data_real/ at full width, JAX's float32 loss and the port's
    float32 loss are both far from the port's float64 loss at one step an hour,
    and all three agree at two steps.
    """
    path = os.path.join(os.path.dirname(__file__), os.pardir, "data_real")
    jc, c = JRealCohort(path), RealCohort(path, device="cpu")
    jc.split_sample()
    c.split_sample()
    batch, jbatch = c.get_split("train", 8, 1), jc.get_split("train", 8, 1)
    batch64 = {k: v.double() for k, v in batch.items()}
    rel = {}
    for div in (1, 2):
        jm = j_build_real_model("hybrid", 28, 1, 11, 97, 1.0, ode_step_div=div)
        m = build_real_model("hybrid", 28, 1, 11, 97, 1.0, ode_step_div=div)
        jparams = j_init_vi(jax.random.PRNGKey(1), jm)
        j_loss = float(jax.jit(j_elbo.real_loss, static_argnums=1)(jparams, jm, jbatch, jax.random.PRNGKey(0)))
        params = params_from_jax(jparams, device="cpu")
        with torch.no_grad():
            loss = real_loss(params, m, batch).item()
            loss64 = real_loss(copy.deepcopy(params).double(), m, batch64).item()
        rel[div] = abs(j_loss - loss64) / loss64, abs(loss - loss64) / loss64
    assert min(rel[1]) > 1e-2, rel
    assert max(rel[2]) < 1e-5, rel
