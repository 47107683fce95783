"""Expert + hybrid PK/PD vector field (counterpart of hybridode/fields/roche.py:20-89).

`roche_field(t, y, args)` with args = (params, DoseContext). The 13 expert
rate constants and the ablation thetas are frozen parameters
(`requires_grad=False`), as the JAX package's optimizer mask freezes them
(hybridode/inference/train.py:31-51); the hybrid remainder is a Linear+Tanh
net driven by the full state.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..config import DTYPE, ROCHE_PARAM_NAMES, RocheConfig
from ..models import nn
from . import dose as dose_lib

# Keys of the field's parameter tree that training never updates.
FROZEN_KEYS = ("expert", "theta_1", "theta_2")


def init_roche_field(generator, latent_dim: int, roche_config: RocheConfig | None = None, ablate: bool = False,
                     dtype=DTYPE, device=None) -> nn.ParamTree:
    """Build the field's parameters. latent_dim >= 4; dims beyond 4 are the ml remainder."""
    if roche_config is None:
        roche_config = RocheConfig()
    tree = {"expert": {name: torch.tensor(float(getattr(roche_config, name)), dtype=dtype)
                       for name in ROCHE_PARAM_NAMES}}
    ml_dim = latent_dim - 4
    if ml_dim > 0:
        tree["ml_net"] = nn.mlp_init(generator, [latent_dim, ml_dim], dtype=dtype)
    if ablate:
        # Deliberately-wrong linear expert for the ablation study.
        tree["theta_1"] = torch.tensor(1.0, dtype=dtype)
        tree["theta_2"] = torch.tensor(2.0, dtype=dtype)
    return nn.ParamTree(tree, frozen_keys=FROZEN_KEYS).to(resolve_device(device))


def _abs_pow(x, p):
    """|x|**p, the Hill terms: the even-power value for the trial states that dip below 0."""
    return torch.pow(torch.abs(x), p)


def roche_field(t, y, args):
    """dy/dt for the expert/hybrid Roche model. y: (B, D), D = 4 + ml_dim."""
    params, ctx = args
    e = params["expert"]

    Disease = y[..., 0]
    ImmuneReact = y[..., 1]
    Immunity = y[..., 2]
    Dose2 = y[..., 3]

    if "theta_1" in params:  # ablation: wrong linear expert
        dxdt1 = ImmuneReact
        dxdt2 = -1.0 * Disease * params["theta_1"]
        dxdt3 = Dose2
        dxdt4 = -1.0 * Immunity * params["theta_2"]
    else:
        Dose = dose_lib.exp_decay_dose(t, ctx, e["kel"])

        dxdt1 = (
            Disease * e["k_disprog"]
            - Disease * _abs_pow(Immunity, e["HillCure"]) * e["k_discure_immunity"]
            - Disease * ImmuneReact * e["k_discure_immunereact"]
        )

        ir_hill = _abs_pow(ImmuneReact, e["HillPatho"])
        dxdt2 = (
            Disease * e["k_immune_disease"]
            - ImmuneReact * e["k_immune_off"]
            + Disease * ImmuneReact * e["k_immune_feedback"]
            + (ir_hill * e["emax_patho"]) / (_abs_pow(e["ec50_patho"], e["HillPatho"]) + ir_hill)
            - Dose2 * ImmuneReact * e["k_dexa"]
        )

        dxdt3 = ImmuneReact * e["k_immunity"]
        dxdt4 = e["kel"] * Dose - e["kel"] * Dose2

    expert_dxdt = torch.stack([dxdt1, dxdt2, dxdt3, dxdt4], dim=-1)

    if "ml_net" in params:
        dmldt = nn.mlp(params["ml_net"], y, final_activation=torch.tanh)
        return torch.cat([expert_dxdt, dmldt], dim=-1)
    return expert_dxdt
