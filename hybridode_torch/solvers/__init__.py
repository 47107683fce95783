"""Batched, differentiable ODE integrators (counterpart of hybridode/solvers/__init__.py).

`odeint` is the single entry point. Methods:

* "dopri5"          — adaptive Dormand-Prince 5(4), dense output at `ts`
* "rk4" / "midpoint" / "euler" / "explicit_adams" — fixed-step
"""

from __future__ import annotations

from typing import Any

import torch

from .adjoint import odeint_dopri5_adjoint
from .calibrate import calibrate_trial_budget
from .dopri5 import Dopri5Stats, odeint_dopri5
from .fixed_step import odeint_fixed

ADAPTIVE_METHODS = ("dopri5",)
FIXED_METHODS = ("rk4", "midpoint", "euler", "explicit_adams")


def odeint(
    field,
    y0: torch.Tensor,
    ts,
    args: Any = None,
    *,
    method: str = "dopri5",
    rtol: float = 1e-7,
    atol: float = 1e-8,
    step_size: float | None = None,
    n_substeps: int | None = None,
    max_steps: int = 256,
    barriers=None,
):
    """Solve dy/dt = field(t, y, args); return y at `ts`, shape (len(ts), *y0.shape).

    The whole state integrates in lockstep (one step-size controller).
    """
    if method in ADAPTIVE_METHODS:
        ys, _ = odeint_dopri5(field, y0, ts, args, rtol=rtol, atol=atol, max_steps=max_steps, barriers=barriers)
        return ys
    if method in FIXED_METHODS:
        return odeint_fixed(field, y0, ts, args, method=method, step_size=step_size, n_substeps=n_substeps)
    raise ValueError(f"unknown method {method!r}; choose from {ADAPTIVE_METHODS + FIXED_METHODS}")


def odeint_with_stats(field, y0, ts, args=None, *, rtol=1e-7, atol=1e-8, max_steps=256):
    """Adaptive lockstep solve that also reports step counts."""
    return odeint_dopri5(field, y0, ts, args, rtol=rtol, atol=atol, max_steps=max_steps)


__all__ = [
    "odeint",
    "odeint_with_stats",
    "odeint_dopri5",
    "odeint_dopri5_adjoint",
    "calibrate_trial_budget",
    "odeint_fixed",
    "Dopri5Stats",
    "ADAPTIVE_METHODS",
    "FIXED_METHODS",
]
