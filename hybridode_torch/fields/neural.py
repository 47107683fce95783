"""Black-box neural ODE vector field, the simulation baseline (counterpart of hybridode/fields/neural.py).

An MLP (latent+1) -> 10*latent -> latent with tanh on both layers; the dose
enters as an impulse concatenated to the state.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..config import DTYPE
from ..models import nn
from . import dose as dose_lib


def init_neural_field(generator, latent_dim: int, dtype=DTYPE, device=None) -> nn.ParamTree:
    tree = {"ml_net": nn.mlp_init(generator, [latent_dim + 1, latent_dim * 10, latent_dim], dtype=dtype)}
    return nn.ParamTree(tree).to(resolve_device(device))


def neural_field(t, y, args):
    """dy/dt = MLP([y, impulse_dose(t)]). y: (B, D)."""
    params, ctx = args
    dose = dose_lib.impulse_dose(t, ctx)  # (B,)
    y_full = torch.cat([y, dose[..., None]], dim=-1)
    return nn.mlp(params["ml_net"], y_full, final_activation=torch.tanh)
