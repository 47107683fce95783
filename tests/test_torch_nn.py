"""Port vs JAX: linear, MLP, reverse LSTM scan and the LSTM encoder on the CPU.

Non-square weights throughout, so an (in, out) vs (out, in) or a gate-order
mistake cannot hide. Tolerance rtol=1e-5, atol=1e-6 (matmul summation order
differs between XLA and PyTorch on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hybridode.models import encoders as j_encoders
from hybridode.models import nn as j_nn
from hybridode_torch.convert import params_from_jax
from hybridode_torch.models import encoders, nn

RTOL, ATOL = 1e-5, 1e-6


def _port(tree):
    return params_from_jax(tree, device="cpu")


def test_linear_and_mlp_non_square():
    rng = np.random.RandomState(0)
    x = rng.randn(9, 5).astype(np.float32)
    jp = j_nn.mlp_init(jax.random.PRNGKey(0), [5, 7, 3])
    p = _port({"mlp": jp})["mlp"]
    assert tuple(p[0]["w"].shape) == (5, 7)
    with torch.no_grad():
        np.testing.assert_allclose(nn.linear(p[0], torch.from_numpy(x)).numpy(),
                                   np.asarray(j_nn.linear_apply(jp[0], jnp.asarray(x))), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(nn.mlp(p, torch.from_numpy(x), final_activation=torch.tanh).numpy(),
                                   np.asarray(j_nn.mlp_apply(jp, jnp.asarray(x), final_activation=jnp.tanh)),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("reverse", [True, False])
@pytest.mark.parametrize("return_all", [True, False])
def test_lstm_scan(reverse, return_all):
    rng = np.random.RandomState(1)
    xs = rng.randn(6, 4, 5).astype(np.float32)  # (T, B, in), in != hidden
    jp = j_nn.lstm_init(jax.random.PRNGKey(1), 5, 3)
    want = j_nn.lstm_scan(jp, jnp.asarray(xs), 3, reverse=reverse, return_all=return_all)
    with torch.no_grad():
        got = nn.lstm_scan(_port(jp), torch.from_numpy(xs), 3, reverse=reverse, return_all=return_all)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("normalize", [True, False])
def test_encoder_lstm_apply(normalize):
    rng = np.random.RandomState(2)
    T, B, obs, act = 5, 8, 7, 1
    spec = j_encoders.EncoderLSTMSpec(obs + act, 11, 6, normalize=normalize)
    jp = j_encoders.init_encoder_lstm(jax.random.PRNGKey(2), spec)
    x = rng.randn(T, B, obs).astype(np.float32)
    a = (rng.rand(T, B, act) * (rng.rand(T, B, act) > 0.8)).astype(np.float32)
    mask = (rng.rand(T, B, obs) > 0.5).astype(np.float32)
    want = j_encoders.encoder_lstm_apply(jp, spec, jnp.asarray(x), jnp.asarray(a), jnp.asarray(mask))
    pspec = encoders.EncoderLSTMSpec(*spec)
    with torch.no_grad():
        got = encoders.encoder_lstm_apply(_port(jp), pspec, torch.from_numpy(x), torch.from_numpy(a),
                                          torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_init_bounds_follow_pytorch_defaults():
    p = encoders.init_encoder_lstm(torch.Generator().manual_seed(0), encoders.EncoderLSTMSpec(21, 40, 6),
                                   device="cpu")
    assert p["lstm"]["w_ih"].abs().max() <= 1 / np.sqrt(40)
    assert p["lin"]["w"].abs().max() <= 1 / np.sqrt(40)
    assert tuple(p["lstm"]["w_ih"].shape) == (21, 160) and tuple(p["lin"]["w"].shape) == (40, 6)
