"""Simulation decoder: initial latent -> ODE solve -> observation head.

Counterpart of `SimDecoderSpec`, `init_sim_decoder` and `sim_decoder_apply`
(hybridode/models/decoders.py:44-170), for the Roche field (`roche=True`)
and the black-box neural field (`roche=False`).

Three solves:

* DOPRI5 with per-patient step control (`per_sample_control=True`, the CLI's
  default for the Roche field): one `odeint_dopri5(per_row=True)` over the
  batch, the counterpart of JAX's `vmap` of one solve per patient.
* The RK4 solve of the Roche field runs the CUDA kernel `roche_rk4_trajectory`
  when the configuration is the one that kernel computes: `method == "rk4"`,
  the Roche field without ablation, `latent_dim <= 8`, one dose per patient,
  a CUDA state and no gradient needed.
* Every other configuration solves with `odeint` in plain PyTorch (DOPRI5 in
  lockstep, or a fixed-step method).

The lockstep DOPRI5 of the JAX package's `--step_control lockstep`
(`use_adjoint=True`, a while-loop adjoint solver) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import DTYPE, RocheConfig
from ..fields import doses_from_actions, init_neural_field, init_roche_field, neural_field, roche_field
from ..ops.roche_rk4 import MAX_DIM, roche_rk4_trajectory
from ..solvers import odeint, odeint_dopri5
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


def init_sim_decoder(generator, spec: SimDecoderSpec, roche_config: RocheConfig | None = None, dtype=DTYPE,
                     device=None) -> nn.ParamTree:
    device = resolve_device(device)
    if spec.roche:
        ode = init_roche_field(generator, spec.latent_dim, roche_config, ablate=spec.ablate, dtype=dtype,
                               device=device)
    else:
        ode = init_neural_field(generator, spec.latent_dim, dtype=dtype, device=device)
    tree = {"ode": ode, "output": nn.linear_init(generator, spec.latent_dim, spec.obs_dim, dtype=dtype)}
    return nn.ParamTree(tree).to(device)


def _runs_kernel(spec: SimDecoderSpec, params, init, ctx) -> bool:
    needs_grad = torch.is_grad_enabled() and (init.requires_grad or any(p.requires_grad for p in params.parameters()))
    return (spec.method == "rk4" and spec.roche and not spec.ablate and 4 <= spec.latent_dim <= MAX_DIM
            and ctx.times.shape[-1] == 1 and init.is_cuda and not needs_grad)


def sim_decoder_apply(params, spec: SimDecoderSpec, init, actions):
    """(B, D) initial latents + (T, B, A) actions -> (x_hat, h)."""
    ctx = doses_from_actions(actions, spec.step_size)
    ts = torch.as_tensor(spec.ts, device=init.device)
    ode = params["ode"]
    field = roche_field if spec.roche else neural_field
    if spec.method == "dopri5" and spec.use_adjoint:
        raise NotImplementedError("lockstep DOPRI5 on the adjoint solver (--step_control lockstep) is not ported "
                                  "yet (ROADMAP.md, queue 1, item 9)")
    if spec.method == "dopri5" and spec.per_sample_control:
        h, _ = odeint_dopri5(field, init, ts, (ode, ctx), rtol=spec.rtol, atol=spec.atol,
                             max_steps=spec.max_steps, per_row=True)
    elif _runs_kernel(spec, ode, init, ctx):
        ml = ode["ml_net"][0] if "ml_net" in ode else None
        h = roche_rk4_trajectory(init.contiguous(), ctx.times[:, 0].contiguous(), ctx.amounts.contiguous(),
                                 ode["expert"], None if ml is None else ml["w"], None if ml is None else ml["b"],
                                 ts, spec.n_substeps)
    else:
        h = odeint(field, init, ts, (ode, ctx), method=spec.method, rtol=spec.rtol, atol=spec.atol,
                   step_size=spec.ode_step_size, n_substeps=spec.n_substeps, max_steps=spec.max_steps)
    x_hat = nn.linear(params["output"], h)
    return x_hat, h
