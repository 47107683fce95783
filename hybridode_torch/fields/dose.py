"""Dose forcing as functions of `t` (counterpart of hybridode/fields/dose.py:19-55).

Dose times are fixed-width `(B, max_doses)` tensors; absent doses carry the
sentinel time NO_DOSE_TIME so `t >= times` is never true.
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


def exp_decay_dose(t, ctx: DoseContext, kel) -> torch.Tensor:
    """Depot concentration: amount * sum_j exp(kel*(t_j - t)) 1[t>=t_j]."""
    active = t >= ctx.times  # (B, max_doses)
    zero = torch.zeros((), dtype=ctx.times.dtype, device=ctx.times.device)
    delta = torch.where(active, ctx.times - t, zero)
    contrib = torch.where(active, torch.exp(kel * delta), zero)
    return ctx.amounts * torch.sum(contrib, dim=-1)
