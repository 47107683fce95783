"""Real-data (ICU cohort) vector fields (counterpart of hybridode/fields/real.py:26-92).

* `roche_real_field`: learned dDisease/dImmuneReact nets over the expert
  sub-states (tanh-saturated), closed-form immunity and depot dynamics with
  trainable 0-d rate constants `k_immunity`, `kel`, `kel2`, and a
  continuous-time GRU remainder when the latent is wider than the 4 expert
  states.
* `neural_real_field`: a black-box MLP over the state and the cumulative dose.
* `neural_real_2nd_field`: second-order latent dynamics; the MLP drives the
  velocity half and the position half integrates it.

args = (params, CumDoseContext): the full (T, B, A) action sequence rides in
the context. Every leaf trains (the real track's optimizer has no frozen key).
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..config import DTYPE
from ..models import nn
from . import dose as dose_lib

EXPERT_DIM = 4


def init_roche_real_field(generator, latent_dim: int, hidden_dim: int, dtype=DTYPE, device=None) -> nn.ParamTree:
    ml_dim = latent_dim - EXPERT_DIM
    tree = {
        "dx1_net": nn.mlp_init(generator, [3, hidden_dim, 1], dtype=dtype),
        "dx2_net": nn.mlp_init(generator, [2, hidden_dim, 1], dtype=dtype),
        "k_immunity": torch.tensor(1.0, dtype=dtype),
        "kel": torch.tensor(0.2, dtype=dtype),
        "kel2": torch.tensor(0.2, dtype=dtype),
    }
    if ml_dim > 0:
        for name in ("lin_hr", "lin_hz", "lin_hh"):
            tree[name] = nn.linear_init(generator, ml_dim, ml_dim, bias=False, dtype=dtype)
    return nn.ParamTree(tree).to(resolve_device(device))


def roche_real_field(t, y, args):
    """dy/dt of the real-data hybrid: y (..., B, D), D = 4 expert states + the GRU remainder."""
    p, ctx = args
    ImmuneReact = y[..., 1]
    Dose2 = y[..., 3]
    Dose = dose_lib.exp_decay_dose_seq(t, ctx, p["kel"])

    dxdt1 = nn.mlp(p["dx1_net"], y[..., :3], final_activation=torch.tanh)
    dxdt2 = nn.mlp(p["dx2_net"], y[..., :2], final_activation=torch.tanh)
    dxdt3 = (ImmuneReact * p["k_immunity"])[..., None]
    dxdt4 = (p["kel"] * Dose - p["kel2"] * Dose2)[..., None]

    expert = torch.cat([dxdt1, dxdt2, dxdt3, dxdt4], dim=-1)
    if "lin_hr" not in p:
        return expert

    h = y[..., EXPERT_DIM:]
    r = torch.sigmoid(nn.linear(p["lin_hr"], h))
    z = torch.sigmoid(nn.linear(p["lin_hz"], h))
    u = torch.tanh(nn.linear(p["lin_hh"], r * h))
    dmldt = (1 - z) * (u - h)
    return torch.cat([expert, dmldt], dim=-1)


def init_neural_real_field(generator, latent_dim: int, action_dim: int, hidden_dim: int, dtype=DTYPE,
                           device=None) -> nn.ParamTree:
    tree = {"ml_net": nn.mlp_init(generator, [latent_dim + action_dim, hidden_dim, latent_dim], dtype=dtype)}
    return nn.ParamTree(tree).to(resolve_device(device))


def neural_real_field(t, y, args):
    p, ctx = args
    dose = dose_lib.cumulative_dose(t, ctx)  # (..., B, A)
    return nn.mlp(p["ml_net"], torch.cat([y, dose], dim=-1), final_activation=torch.tanh)


def init_neural_real_2nd_field(generator, latent_dim: int, action_dim: int, hidden_dim: int, dtype=DTYPE,
                               device=None) -> nn.ParamTree:
    tree = {"ml_net": nn.mlp_init(generator, [latent_dim + action_dim, hidden_dim, latent_dim // 2], dtype=dtype)}
    return nn.ParamTree(tree).to(resolve_device(device))


def neural_real_2nd_field(t, y, args):
    p, ctx = args
    dose = dose_lib.cumulative_dose(t, ctx)
    dml1dt = nn.mlp(p["ml_net"], torch.cat([y, dose], dim=-1), final_activation=torch.tanh)
    dml2dt = y[..., : y.shape[-1] // 2]
    return torch.cat([dml1dt, dml2dt], dim=-1)
