"""Variational posterior encoders (counterpart of hybridode/models/encoders.py:26-59 and :134-173).

`encoder_lstm_*`: the simulation track's reversed LSTM. `encoder_lstm_real_*`:
the real track's LSTM over [x, a, time], with 2-layer tanh MLP heads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..config import DTYPE
from . import nn


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
