"""Dose forcing as functions of `t` (counterpart of hybridode/fields/dose.py:19-65).

Dose times are fixed-width `(B, max_doses)` tensors; absent doses carry the
sentinel time NO_DOSE_TIME so `t >= times` is never true.

`t` is a scalar (one time for the whole batch) or a per-row time of shape
`(B, 1)`, as the per-row DOPRI5 solver passes it. A per-row time of shape
`(B,)` would broadcast against `(B, max_doses)` into `(B, B)` and mix one
patient's dose into another's, so the dose functions refuse it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NO_DOSE_TIME = 1e30


class DoseContext(NamedTuple):
    """Per-patient bolus doses: `times` (B, max_doses), `amounts` (B,)."""

    times: torch.Tensor
    amounts: torch.Tensor


def doses_from_actions(actions: torch.Tensor, step_size: float = 1.0, max_doses: int = 1) -> DoseContext:
    """Extract the dose schedule from a (T, B, 1) action array.

    Dose times are the indices of nonzero actions times step_size, earliest
    first; the amount is the max action over time. JAX takes `lax.top_k` of
    the 0/1 indicator, which puts equal values in index order: a stable
    descending sort gives exactly the same indices.
    """
    a = actions[..., 0]  # (T, B)
    amounts = torch.amax(a, dim=0)
    indicator = (a != 0).to(actions.dtype).T  # (B, T)
    vals, idx = torch.sort(indicator, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :max_doses], idx[:, :max_doses]
    times = idx.to(actions.dtype) * step_size
    times = torch.where(vals > 0, times, torch.full_like(times, NO_DOSE_TIME))
    return DoseContext(times=times, amounts=amounts)


def _check_time(t):
    if getattr(t, "ndim", 0) == 1:
        raise ValueError(f"a per-row time must have shape (B, 1), not {tuple(t.shape)}")


def exp_decay_dose(t, ctx: DoseContext, kel) -> torch.Tensor:
    """Depot concentration: amount * sum_j exp(kel*(t_j - t)) 1[t>=t_j]."""
    _check_time(t)
    active = t >= ctx.times  # (B, max_doses)
    zero = torch.zeros((), dtype=ctx.times.dtype, device=ctx.times.device)
    delta = torch.where(active, ctx.times - t, zero)
    contrib = torch.where(active, torch.exp(kel * delta), zero)
    return ctx.amounts * torch.sum(contrib, dim=-1)


def impulse_dose(t, ctx: DoseContext) -> torch.Tensor:
    """Impulse dose: the amount iff the solver evaluates exactly at a dose time.

    The exact float equality is deliberate parity with the reference's NODE
    baseline, which only sees the dose when a stage lands on the dose time.
    """
    _check_time(t)
    return ctx.amounts * torch.sum((ctx.times == t).to(ctx.amounts.dtype), dim=-1)
