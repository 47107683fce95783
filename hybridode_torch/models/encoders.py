"""Variational posterior encoders and the LSTM baseline (counterpart of hybridode/models/encoders.py:26-205).

`encoder_lstm_*`: the simulation track's reversed LSTM. `encoder_planar_lstm_*`:
the same LSTM with amortised planar-flow heads, and `planar_reparameterize` /
`planar_log_density`, the flow posterior (LHM-NF). `encoder_lstm_real_*`: the
real track's LSTM over [x, a, time], with 2-layer tanh MLP heads.
`lstm_baseline_*`: the discrete supervised baseline (LSTMBaseline), an LSTM
forward in time with an ELU MLP head and a masked next-step MSE.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..config import DTYPE
from . import flows, nn, priors


class EncoderLSTMSpec(NamedTuple):
    input_dim: int
    hidden_dim: int
    output_dim: int
    normalize: bool = True
    model_name: str = "LSTMEncoder"


def init_encoder_lstm(generator, spec: EncoderLSTMSpec, dtype=DTYPE, device=None) -> nn.ParamTree:
    tree = {
        "lstm": nn.lstm_init(generator, spec.input_dim, spec.hidden_dim, dtype),
        "lin": nn.linear_init(generator, spec.hidden_dim, spec.output_dim, dtype=dtype),
        "log_var": nn.linear_init(generator, spec.hidden_dim, spec.output_dim, dtype=dtype),
    }
    return nn.ParamTree(tree).to(resolve_device(device))


def encoder_lstm_apply(params, spec: EncoderLSTMSpec, x, a, mask):
    """(T,B,obs) observations + (T,B,A) actions + mask -> (mu, log_var).

    Runs the LSTM backwards in time over mask-zeroed inputs; the
    `exp(mu)/10`, `log_var - 5` positivity normalisation is what the
    Exponential prior needs.
    """
    y_in = torch.cat([x, a], dim=-1)
    mask_in = torch.cat([mask, torch.ones_like(a)], dim=-1)
    out = nn.lstm_scan(params["lstm"], y_in * mask_in, spec.hidden_dim, reverse=True)

    mu = nn.linear(params["lin"], out)
    log_var = nn.linear(params["log_var"], out)
    if spec.normalize:
        mu = torch.exp(mu) / 10.0
        log_var = log_var - 5.0
    return mu, log_var


class EncoderPlanarLSTMSpec(NamedTuple):
    input_dim: int
    hidden_dim: int
    output_dim: int
    num_flows: int
    normalize: bool = True
    model_name: str = "PlanarLSTMEncoder"


def init_encoder_planar_lstm(generator, spec: EncoderPlanarLSTMSpec, dtype=DTYPE, device=None) -> nn.ParamTree:
    H, K, D = spec.hidden_dim, spec.num_flows, spec.output_dim
    tree = {
        "lstm": nn.lstm_init(generator, spec.input_dim, H, dtype),
        "lin": nn.linear_init(generator, H, D, dtype=dtype),
        "log_var": nn.linear_init(generator, H, D, dtype=dtype),
        "amor_u": nn.linear_init(generator, H, K * D, dtype=dtype),
        "amor_w": nn.linear_init(generator, H, K * D, dtype=dtype),
        "amor_b": nn.linear_init(generator, H, K, dtype=dtype),
    }
    return nn.ParamTree(tree).to(resolve_device(device))


def encoder_planar_lstm_apply(params, spec: EncoderPlanarLSTMSpec, x, a, mask):
    """-> (mu, log_var, u, w, b): the posterior of `encoder_lstm_apply` and the amortised
    flow parameters u (B, K, D, 1), w (B, K, 1, D), b (B, K, 1, 1) for K = num_flows."""
    B, K, D = x.shape[1], spec.num_flows, spec.output_dim
    y_in = torch.cat([x, a], dim=-1)
    mask_in = torch.cat([mask, torch.ones_like(a)], dim=-1)
    out = nn.lstm_scan(params["lstm"], y_in * mask_in, spec.hidden_dim, reverse=True)

    mu = nn.linear(params["lin"], out)
    log_var = nn.linear(params["log_var"], out)
    u = nn.linear(params["amor_u"], out).reshape(B, K, D, 1)
    w = nn.linear(params["amor_w"], out).reshape(B, K, 1, D)
    b = nn.linear(params["amor_b"], out).reshape(B, K, 1, 1)
    if spec.normalize:
        mu = torch.exp(mu) / 10.0
        log_var = log_var - 5.0
    return mu, log_var, u, w, b


def planar_reparameterize(encoder_out, num_flows: int, eps):
    """z0 = mu + eps * std, through the planar flows, then the fixed exp(z - 5) positivity
    layer, whose log-det sum(z - 5) joins the flows'.

    `eps` is (B, D), or (mc, B, D) for mc draws at once (the flow parameters
    broadcast). Returns (mu, log_var, z_final, log_det_j, z0).
    """
    mu, log_var, u, w, b = encoder_out
    z0 = priors.gaussian_reparameterize(mu, log_var, eps)
    z = z0
    log_det_j = 0.0
    for k in range(num_flows):
        z, ldj = flows.planar_flow(z, u[:, k], w[:, k], b[:, k])
        log_det_j = log_det_j + ldj
    z_exp = torch.exp(z - 5.0)
    log_det_j = log_det_j + torch.sum(z - 5.0, dim=-1)
    return mu, log_var, z_exp, log_det_j, z0


def planar_log_density(mu, log_var, z_final, log_det_j, z0):
    """log q(z_final) = log q0(z0) - log|det J|."""
    return priors.gaussian_log_density(mu, log_var, z0) - log_det_j


class EncoderLSTMRealSpec(NamedTuple):
    input_dim: int
    hidden_dim: int
    output_dim: int
    output_all: bool = False
    reverse: bool = True
    model_name: str = "LSTMReal"


def init_encoder_lstm_real(generator, spec: EncoderLSTMRealSpec, dtype=DTYPE, device=None) -> nn.ParamTree:
    heads = [spec.hidden_dim, spec.hidden_dim + 1, spec.output_dim]
    tree = {
        "lstm": nn.lstm_init(generator, spec.input_dim, spec.hidden_dim, dtype),
        "lin": nn.mlp_init(generator, heads, dtype=dtype),
        "log_var": nn.mlp_init(generator, heads, dtype=dtype),
    }
    return nn.ParamTree(tree).to(resolve_device(device))


def encoder_lstm_real_apply(params, spec: EncoderLSTMRealSpec, x, a, m):
    """LSTM over [x, a, t / max(mask)] (flipped in time when `spec.reverse`) -> (mu, log_var).

    The time feature divides the step index by the mask's maximum, as the
    reference does (with a 0/1 mask it is the raw index). With `output_all`
    the heads' outputs at every step come back, (T, B, D); else the last, (B, D).
    """
    if spec.reverse:
        x, a, m = x.flip(0), a.flip(0), m.flip(0)

    T, B = m.shape[0], m.shape[1]
    t_feat = torch.arange(T, dtype=x.dtype, device=x.device)[:, None, None] / torch.max(m)
    x_in = torch.cat([x, a, t_feat.expand(T, B, 1)], dim=-1)

    hs = nn.lstm_scan(params["lstm"], x_in, spec.hidden_dim, return_all=True)
    mu = nn.mlp(params["lin"], hs, final_activation=torch.tanh)
    log_var = nn.mlp(params["log_var"], hs, final_activation=torch.tanh)
    if spec.output_all:
        return mu, log_var
    return mu[-1], log_var[-1]


# --- LSTMBaseline (the discrete supervised baseline, hybridode/models/encoders.py:176-205) ----------------------


class LSTMBaselineSpec(NamedTuple):
    input_dim: int
    hidden_dim: int
    output_dim: int
    model_name: str = "LSTMBaseline"


def init_lstm_baseline(generator, spec: LSTMBaselineSpec, dtype=DTYPE, device=None) -> nn.ParamTree:
    tree = {
        "lstm": nn.lstm_init(generator, spec.input_dim, spec.hidden_dim, dtype),
        "out": nn.mlp_init(generator, [spec.hidden_dim, spec.hidden_dim + 1, spec.output_dim], dtype=dtype),
    }
    return nn.ParamTree(tree).to(resolve_device(device))


def lstm_baseline_apply(params, spec: LSTMBaselineSpec, x, a, mask):
    """(T,B,obs) observations + (T,B,A) inputs -> (T,B,output_dim): an LSTM forward in time, then Linear, ELU,
    Linear at every step. `mask` is unused, as in JAX."""
    hs = nn.lstm_scan(params["lstm"], torch.cat([x, a], dim=-1), spec.hidden_dim, return_all=True)
    return nn.mlp(params["out"], hs, activation=nn.elu)


def lstm_baseline_loss(params, spec: LSTMBaselineSpec, batch):
    """Masked next-step MSE over the batch: actions and statics are the inputs beside the observations."""
    x, a, mask, s = batch["measurements"], batch["actions"], batch["masks"], batch["statics"]
    x_hat = lstm_baseline_apply(params, spec, x, torch.cat([a, s], dim=-1), mask)[:-1]
    return torch.sum((x[1:] - x_hat) ** 2 * mask[1:]) / x.shape[1]
