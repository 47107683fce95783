"""Gaussian reparameterisation and priors (counterpart of hybridode/models/priors.py).

Noise always comes in as `eps`: the caller draws it from its own
`torch.Generator` (or hands in the JAX package's draws, as the parity tests do).
"""

from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


def gaussian_reparameterize(mu, log_var, eps):
    """z = mu + eps * exp(log_var / 2); `eps` broadcasts against mu."""
    std = torch.exp(0.5 * log_var)
    return eps * std + mu


def gaussian_log_density(mu, log_var, z):
    """sum_d log N(z_d | mu_d, exp(log_var_d)) over the last axis."""
    lp = -0.5 * (_LOG_2PI + log_var + (z - mu) ** 2 / torch.exp(log_var))
    return torch.sum(lp, dim=-1)


def standard_normal_log_density(z):
    return torch.sum(-0.5 * (_LOG_2PI + z**2), dim=-1)


def exponential_log_density(z, rate: float = 100.0):
    """log Exponential(rate).pdf summed over the last axis, with no support check."""
    return torch.sum(math.log(rate) - rate * z, dim=-1)
