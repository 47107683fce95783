"""Batched ODE integrators (counterpart of hybridode/solvers/__init__.py).

`odeint` is the single entry point. This slice carries the fixed-step
methods; the adaptive Dormand-Prince solver comes with the training slice.
"""

from __future__ import annotations

from typing import Any

import torch

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
):
    """Solve dy/dt = field(t, y, args); return y at `ts`, shape (len(ts), *y0.shape)."""
    if method in ADAPTIVE_METHODS:
        raise NotImplementedError(
            f"method {method!r} is not ported yet (ROADMAP.md, queue 1, item 2: per-sample DOPRI5); "
            f"use one of {FIXED_METHODS}"
        )
    if method in FIXED_METHODS:
        return odeint_fixed(field, y0, ts, args, method=method, step_size=step_size, n_substeps=n_substeps)
    raise ValueError(f"unknown method {method!r}; choose from {ADAPTIVE_METHODS + FIXED_METHODS}")


__all__ = ["odeint", "odeint_fixed", "ADAPTIVE_METHODS", "FIXED_METHODS"]
