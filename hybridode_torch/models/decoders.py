"""Simulation decoder: initial latent -> ODE solve -> observation head.

Counterpart of `SimDecoderSpec`, `init_sim_decoder` and `sim_decoder_apply`
(hybridode/models/decoders.py:44-170). The Roche field is ported; the
black-box neural field (`roche=False`) comes with a later slice.

The RK4 solve of the Roche field runs the CUDA kernel `roche_rk4_trajectory`
when the configuration is the one that kernel computes: `method == "rk4"`,
the Roche field without ablation, `latent_dim <= 8`, one dose per patient, a
CUDA state and no gradient needed. Every other configuration solves with
`odeint` over `roche_field` in plain PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import DTYPE, RocheConfig
from ..fields import doses_from_actions, init_roche_field, roche_field
from ..ops.roche_rk4 import MAX_DIM, roche_rk4_trajectory
from ..solvers import odeint
from . import nn


class SimDecoderSpec(NamedTuple):
    obs_dim: int
    latent_dim: int
    action_dim: int
    t_max: float
    step_size: float
    roche: bool = True
    ablate: bool = False
    method: str = "dopri5"
    rtol: float = 1e-7
    atol: float = 1e-8
    ode_step_size: Optional[float] = None
    max_steps: int = 512
    per_sample_control: bool = False
    use_adjoint: bool = False
    max_record: Optional[int] = None

    @property
    def model_name(self) -> str:
        if self.roche:
            name = "ExpertDecoder" if self.latent_dim == 4 else "HybridDecoder"
        else:
            name = "NeuralODEDecoder"
        return name + ("Ablate" if self.ablate else "")

    @property
    def ts(self) -> np.ndarray:
        # Evaluation grid arange(0, t_max + step, step).
        return np.arange(0.0, self.t_max + self.step_size, self.step_size, dtype=np.float32)

    @property
    def n_substeps(self) -> int:
        if self.ode_step_size is None:
            return 1
        return max(1, int(round(self.step_size / self.ode_step_size)))


def _require_roche(spec: SimDecoderSpec):
    if not spec.roche:
        raise NotImplementedError("the neural-ODE decoder (roche=False) is not ported yet (ROADMAP.md, queue 1)")


def init_sim_decoder(generator, spec: SimDecoderSpec, roche_config: RocheConfig | None = None, dtype=DTYPE,
                     device=None) -> nn.ParamTree:
    _require_roche(spec)
    device = resolve_device(device)
    tree = {
        "ode": init_roche_field(generator, spec.latent_dim, roche_config, ablate=spec.ablate, dtype=dtype,
                                device=device),
        "output": nn.linear_init(generator, spec.latent_dim, spec.obs_dim, dtype=dtype),
    }
    return nn.ParamTree(tree).to(device)


def _runs_kernel(spec: SimDecoderSpec, params, init, ctx) -> bool:
    needs_grad = torch.is_grad_enabled() and (init.requires_grad or any(p.requires_grad for p in params.parameters()))
    return (spec.method == "rk4" and spec.roche and not spec.ablate and 4 <= spec.latent_dim <= MAX_DIM
            and ctx.times.shape[-1] == 1 and init.is_cuda and not needs_grad)


def sim_decoder_apply(params, spec: SimDecoderSpec, init, actions):
    """(B, D) initial latents + (T, B, A) actions -> (x_hat, h)."""
    _require_roche(spec)
    ctx = doses_from_actions(actions, spec.step_size)
    ts = torch.as_tensor(spec.ts, device=init.device)
    ode = params["ode"]
    if _runs_kernel(spec, ode, init, ctx):
        ml = ode["ml_net"][0] if "ml_net" in ode else None
        h = roche_rk4_trajectory(init.contiguous(), ctx.times[:, 0].contiguous(), ctx.amounts.contiguous(),
                                 ode["expert"], None if ml is None else ml["w"], None if ml is None else ml["b"],
                                 ts, spec.n_substeps)
    else:
        h = odeint(roche_field, init, ts, (ode, ctx), method=spec.method, rtol=spec.rtol, atol=spec.atol,
                   step_size=spec.ode_step_size, n_substeps=spec.n_substeps, max_steps=spec.max_steps)
    x_hat = nn.linear(params["output"], h)
    return x_hat, h
