"""Variational posterior encoder (counterpart of hybridode/models/encoders.py:26-59)."""

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
