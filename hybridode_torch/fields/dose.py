"""Dose forcing as functions of `t` (counterpart of hybridode/fields/dose.py:19-99).

Dose times are fixed-width `(B, max_doses)` tensors; absent doses carry the
sentinel time NO_DOSE_TIME so `t >= times` is never true.

`t` is a scalar (one time for the whole batch) or a per-row time of shape
`(B, 1)`, as the per-row DOPRI5 solver passes it. A per-row time of shape
`(B,)` would broadcast against `(B, max_doses)` into `(B, B)` and mix one
patient's dose into another's, so the dose functions refuse it.

The real-data kernels (`exp_decay_dose_seq`, `cumulative_dose`) read the whole
`(T, B, A)` action sequence. Their `t` is a scalar or, when a solve runs one
interval per leading slice of an `(N, B, D)` state, a time per slice of shape
`(N, 1, 1)`. They index with tensor operations only, so a time held on the
GPU is never read on the host.
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


class CumDoseContext(NamedTuple):
    """Full action sequence for the real-data kernels: `actions` (T, B, A)."""

    actions: torch.Tensor


def _as_time(t, like: torch.Tensor) -> torch.Tensor:
    _check_time(t)
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def exp_decay_dose_seq(t, ctx: CumDoseContext, kel) -> torch.Tensor:
    """Depot kernel over the whole action sequence: sum_j a_j exp(kel*(j - t)) 1[t >= j], j = 1..T.

    Sums over the time axis and over every action channel; -> (B,), or (N, B) for a time (N, 1, 1).
    """
    a = ctx.actions
    t = _as_time(t, a)
    if t.ndim:
        t = t[..., None]  # (N, 1, 1, 1) against (T, B, A)
    times = torch.arange(1, a.shape[0] + 1, dtype=a.dtype, device=a.device)[:, None, None]  # (T, 1, 1)
    active = t >= times
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    delta = torch.where(active, times - t, zero)
    contrib = torch.where(active, a * torch.exp(kel * delta), zero)
    return torch.sum(contrib, dim=(-3, -1))


def cumulative_dose(t, ctx: CumDoseContext) -> torch.Tensor:
    """Cumulative administered dose up to floor(t), zero from t >= T on; -> (B, A), or (N, B, A)."""
    a = ctx.actions
    T = a.shape[0]
    t = _as_time(t, a)
    cum = torch.cumsum(a, dim=0)  # (T, B, A)
    idx = torch.clamp(torch.floor(t), 0, T - 1).to(torch.long).reshape(-1)
    out = torch.index_select(cum, 0, idx)  # (N or 1, B, A)
    out = out if t.ndim else out[0]
    return torch.where(t >= T, torch.zeros_like(out), out)
