"""Decoders: initial latent -> ODE solve (or discrete unroll) -> observation head.

Counterpart of hybridode/models/decoders.py:44-363:

* the simulation decoder (`SimDecoderSpec`, `init_sim_decoder`,
  `sim_decoder_apply`) for the Roche field (`roche=True`) and the black-box
  neural field (`roche=False`);
* the real-data ODE decoder (`RealDecoderSpec`, `init_real_decoder`,
  `real_decoder_apply`), solved by `odeint` in plain PyTorch (explicit Adams
  on a fixed grid by default), no kernel;
* the real-data discrete benchmarks `tlstm` and `gruode` (`RealBenchmarkSpec`,
  `init_real_benchmark`, `gru_ode_cell`, `real_benchmark_apply`).

The simulation decoder has four solves:

* DOPRI5 with per-patient step control (`per_sample_control=True`, the CLI's
  default for the Roche field): one `odeint_dopri5(per_row=True)` over the
  batch, the counterpart of JAX's `vmap` of one solve per patient. A decode
  of the Roche field runs the same solve as the CUDA kernel
  `roche_dopri5_per_row`, one launch, where it needs no gradient, and as
  `roche_dopri5_per_row_grad`, one launch forward and one backward, where it
  needs one for the state or the remainder (below).
* DOPRI5 on the adjoint solver (`use_adjoint=True`; the CLI's `--step_control
  lockstep` for the Roche field): `odeint_dopri5_adjoint` with one controller
  for the whole `(B, D)` batch, or per row with `per_sample_control`, its
  backward replaying only the accepted steps (at most `max_record` of them).
* The RK4 solve of the Roche field runs the CUDA kernel `roche_rk4_trajectory`
  where that kernel computes it (below).
* Every other configuration solves with `odeint` in plain PyTorch (DOPRI5 in
  lockstep, or a fixed-step method).

The decoder asks only which solve its spec wants of the Roche field without
ablation (`SimDecoderSpec.roche_solve`); whether a kernel computes it, and
which, `ops.contract.roche_kernel` decides from what it observes: a width
the kernels are built for, one dose per patient, a state on a kernel
device, no `torch.func` transform, and which leaves need a gradient. So
`--restart_mode vmap`, the lockstep adjoint, RK4 with gradients, the
trained expert (`train_expert`), the ablation and the neural field, and
every CPU state keep the plain solvers. A decode names its route ("dopri5",
"dopri5_grad", "rk4" or "plain") on the `decode` span its caller has open.

A decode copies nothing from the host: each spec's grid is put on a device
once (`device_grid`), so a training step can be captured into a CUDA graph.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import DTYPE, RocheConfig
from ..fields import (
    CumDoseContext,
    doses_from_actions,
    init_neural_field,
    init_neural_real_2nd_field,
    init_neural_real_field,
    init_roche_field,
    init_roche_real_field,
    neural_field,
    neural_real_2nd_field,
    neural_real_field,
    roche_field,
    roche_real_field,
)
from ..ops.contract import decode_inputs, roche_kernel
from ..ops.roche_dopri5 import roche_dopri5_per_row, roche_dopri5_per_row_grad
from ..ops.roche_rk4 import roche_rk4_trajectory
from ..solvers import FIXED_METHODS, odeint, odeint_dopri5, odeint_dopri5_adjoint
from ..utils.logging import annotate
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

    @property
    def roche_solve(self) -> Optional[str]:
        """The solve of the Roche field without ablation that a kernel may compute (`ops.contract.roche_kernel`):
        per-patient DOPRI5 off the adjoint solver ("dopri5"), RK4 ("rk4"), or None."""
        if not self.roche or self.ablate:
            return None
        if self.method == "dopri5" and self.per_sample_control and not self.use_adjoint:
            return "dopri5"
        return "rk4" if self.method == "rk4" else None


@functools.lru_cache(maxsize=None)
def device_grid(spec, device, dtype=torch.float32) -> torch.Tensor:
    """`spec.ts` as a tensor of `dtype` on `device`, made once per (spec, device, dtype); never written to."""
    return torch.as_tensor(spec.ts, dtype=dtype, device=device)


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


def sim_decoder_apply(params, spec: SimDecoderSpec, init, actions):
    """(B, D) initial latents + (T, B, A) actions -> (x_hat, h)."""
    ctx = doses_from_actions(actions, spec.step_size)
    ts = device_grid(spec, init.device)
    ode = params["ode"]
    field = roche_field if spec.roche else neural_field
    route = roche_kernel(spec.roche_solve, ode, init, ctx)
    annotate("decode", route=route or "plain")
    if route in ("dopri5", "dopri5_grad"):
        solve = roche_dopri5_per_row if route == "dopri5" else roche_dopri5_per_row_grad
        h, _ = solve(*decode_inputs(ode, init, ctx, ts), rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps)
    elif route == "rk4":
        h = roche_rk4_trajectory(*decode_inputs(ode, init, ctx, ts), spec.n_substeps)
    elif spec.method == "dopri5" and spec.use_adjoint:
        h, _ = odeint_dopri5_adjoint(field, init, ts, (ode, ctx), rtol=spec.rtol, atol=spec.atol,
                                     max_steps=spec.max_steps, max_record=spec.max_record,
                                     per_row=spec.per_sample_control)
    elif spec.method == "dopri5" and spec.per_sample_control:
        h, _ = odeint_dopri5(field, init, ts, (ode, ctx), rtol=spec.rtol, atol=spec.atol,
                             max_steps=spec.max_steps, per_row=True)
    else:
        h = odeint(field, init, ts, (ode, ctx), method=spec.method, rtol=spec.rtol, atol=spec.atol,
                   step_size=spec.ode_step_size, n_substeps=spec.n_substeps, max_steps=spec.max_steps)
    x_hat = nn.linear(params["output"], h)
    return x_hat, h


# --- Real-data decoder ----------------------------------------------------------

_REAL_FIELDS = {
    "neural": neural_real_field,
    "2nd": neural_real_2nd_field,
    "hybrid": roche_real_field,
    "expert": roche_real_field,
}


class RealDecoderSpec(NamedTuple):
    obs_dim: int
    latent_dim: int
    action_dim: int
    static_dim: int
    hidden_dim: int
    t_max: int
    step_size: float
    t0: int = 0
    method: str = "explicit_adams"
    ode_step_size: Optional[float] = None
    ode_type: str = "neural"
    rtol: float = 1e-7
    atol: float = 1e-8
    max_steps: int = 512

    @property
    def model_name(self) -> str:
        return "DecoderReal_" + self.ode_type

    @property
    def ts(self) -> np.ndarray:
        # Grid arange(t0-1, t_max, step).
        return np.arange(self.t0 - 1, self.t_max, self.step_size, dtype=np.float32)

    @property
    def n_substeps(self) -> int:
        if self.ode_step_size is None:
            return 1
        return max(1, int(round(self.step_size / self.ode_step_size)))


def init_real_decoder(generator, spec: RealDecoderSpec, dtype=DTYPE, device=None) -> nn.ParamTree:
    device = resolve_device(device)
    if spec.ode_type in ("hybrid", "expert"):
        ode = init_roche_real_field(generator, spec.latent_dim, spec.hidden_dim, dtype=dtype, device=device)
    elif spec.ode_type == "2nd":
        ode = init_neural_real_2nd_field(generator, spec.latent_dim, spec.action_dim, spec.hidden_dim, dtype=dtype,
                                         device=device)
    else:
        ode = init_neural_real_field(generator, spec.latent_dim, spec.action_dim, spec.hidden_dim, dtype=dtype,
                                     device=device)
    out = nn.mlp_init(generator, [spec.latent_dim, spec.latent_dim + 1, spec.obs_dim], dtype=dtype)
    return nn.ParamTree({"ode": ode, "output": out}).to(device)


def _real_output(params, h):
    return nn.mlp(params["output"], h, activation=nn.elu)


def real_decoder_apply(params, spec: RealDecoderSpec, init, actions, statics):
    """(B, D) or (T', B, D) initial latents + (T, B, A) actions -> (x_hat, h).

    Rank-2 `init`: one solve over the grid `spec.ts`; x_hat drops the grid's
    first point. Rank-3 `init`: one 2-point solve per interval [ts[i],
    ts[i+1]] from init[i], all intervals in one batched fixed-step solve (the
    counterpart of JAX's vmap), with a zero row prepended and x_hat[0] = 0.
    """
    ctx = CumDoseContext(actions=actions)
    field = _REAL_FIELDS[spec.ode_type]
    ts = device_grid(spec, init.device)
    solve = dict(method=spec.method, step_size=spec.ode_step_size, n_substeps=spec.n_substeps, rtol=spec.rtol,
                 atol=spec.atol, max_steps=spec.max_steps)

    if init.ndim == 2:
        h = odeint(field, init, ts, (params["ode"], ctx), **solve)
        return _real_output(params, h)[1:], h

    if spec.method not in FIXED_METHODS:
        raise NotImplementedError(f"the per-interval (rank-3) decode runs fixed-step methods {FIXED_METHODS}, "
                                  f"not {spec.method!r}")
    n_intervals = spec.t_max - 1
    ts_pairs = torch.stack([ts[:n_intervals], ts[1 : n_intervals + 1]])[..., None, None]  # (2, N, 1, 1)
    h_tail = odeint(field, init[:n_intervals], ts_pairs, (params["ode"], ctx), **solve)[-1]  # (N, B, D)
    h = torch.cat([torch.zeros_like(h_tail[:1]), h_tail], dim=0)
    x_hat = _real_output(params, h)[1:]
    x_hat = torch.cat([torch.zeros_like(x_hat[:1]), x_hat[1:]], dim=0)
    return x_hat, h


# --- Discrete-time benchmark decoders (tlstm / gruode) ---------------------------


class RealBenchmarkSpec(NamedTuple):
    obs_dim: int
    latent_dim: int
    action_dim: int
    static_dim: int
    hidden_dim: int
    t_max: int
    step_size: float
    t0: int = 0
    ode_type: str = "tlstm"

    @property
    def model_name(self) -> str:
        return "DecoderReal_" + self.ode_type

    @property
    def ts(self) -> np.ndarray:
        return np.arange(self.t0, self.t_max, self.step_size, dtype=np.float32)


def init_real_benchmark(generator, spec: RealBenchmarkSpec, dtype=DTYPE, device=None) -> nn.ParamTree:
    D = spec.latent_dim
    tree = {"output": nn.mlp_init(generator, [D, D + 1, spec.obs_dim], dtype=dtype)}
    if spec.ode_type == "tlstm":
        tree["lstm"] = nn.lstm_init(generator, spec.action_dim * 2, D, dtype)
    elif spec.ode_type == "gruode":
        # Bias-free linears on [h, a, time].
        tree["lin_hz"] = nn.linear_init(generator, D + 2, D + 2, bias=False, dtype=dtype)
        tree["lin_hn"] = nn.linear_init(generator, D + 2, D, bias=False, dtype=dtype)
    else:
        raise ValueError(spec.ode_type)
    return nn.ParamTree(tree).to(resolve_device(device))


def gru_ode_cell(params, a, h):
    """One GRU-ODE evaluation -> (dh, h).

    The reference's quirk, kept on purpose: dh is the step's output while the
    hidden state is threaded back unchanged, so the benchmark's trajectory is
    the sequence of dh's.
    """
    hid = h.shape[-1]
    ha = torch.cat([h, a], dim=-1)
    z = torch.sigmoid(nn.linear(params["lin_hz"], ha))
    n = torch.tanh(nn.linear(params["lin_hn"], z * ha))
    dh = (1 - z[..., :hid]) * (n - h)
    return dh, h


def real_benchmark_apply(params, spec: RealBenchmarkSpec, init, actions, statics):
    """Discrete unroll over the grid `spec.ts` (which starts at t0) -> (x_hat, hs)."""
    a_seq = actions[device_grid(spec, actions.device, torch.int64)]  # (T', B, A)
    time_feat = device_grid(spec, actions.device, actions.dtype)[:, None, None] / spec.t_max
    obs_seq = torch.cat([a_seq, time_feat.expand(a_seq.shape)], dim=-1)

    if spec.ode_type == "tlstm":
        state, outs = (init, init), []
        for obs in obs_seq:
            h_new, state = nn.lstm_cell(params["lstm"], obs, state)
            outs.append(h_new)
        hs = torch.stack(outs)
    else:
        # The state never changes, so every step's dh comes from `init`: one cell call over all steps.
        hs, _ = gru_ode_cell(params, obs_seq, init.expand(obs_seq.shape[0], *init.shape))
    return _real_output(params, hs), hs
