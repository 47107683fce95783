"""Batched adaptive Dormand-Prince 5(4) integrator with gradients.

Counterpart of `odeint_dopri5` in hybridode/solvers/dopri5.py:67-291: Hairer's
initial step, the FSAL trial step, the scaled RMS error norm with its
floating-point noise floor, the step-size controller, the dense-output fill of
every grid point a step crosses, NaN at grid points never reached, and
`barriers`. The arithmetic is the JAX function's, in the same order, so the
two agree to float32 rounding and take the same steps.

Two controller granularities:

* `per_row=False` (lockstep): one controller for the whole state, whatever
  its shape; the norms reduce over every element. This is
  `odeint(method="dopri5")`, torchdiffeq's batched semantics.
* `per_row=True`: every row of a `(..., D)` state has its own `t`, `h`,
  `finished` and step counts, and the norms reduce over the last axis. This
  is the port of the `jax.vmap` of one solve per patient
  (hybridode/models/decoders.py:114-135), the sim decoder's default. The
  field then gets a per-row time of shape `y.shape[:-1] + (1,)`, which
  broadcasts against per-row quantities such as the dose times `(B, K)`.

The JAX function runs a bounded `lax.scan` of masked trial steps in chunks of
64 and skips a chunk once the solve has finished. Here the same masked step
runs in a Python loop, and `finished` is read on the host once a chunk (one
sync per 64 trial steps). Rows that have finished are frozen by the masks, so
stopping early gives exactly what the full budget of `ceil(max_steps / 64) *
64` trial steps gives. Inside `full_budget()` every solve runs that whole
budget and reads nothing on the host: the mode of a solve captured into a
CUDA graph or run under `torch.func.vmap` (`inference/fused.py`). The pieces of a solve (`start`, `trial_step`,
`integrate`, `finish`, `replay_step`) are the adjoint solver's too
(`adjoint.py`), so that it records and replays this very arithmetic.

Gradients flow through every trial step's masked selects, as through JAX's
scan (discretize-then-optimize). The initial step, the error norm and the
next step size are computed without gradient, the counterpart of JAX's
`stop_gradient` (dopri5.py:207, :233, :246): `norm ** -0.2` at `norm == 0`
would otherwise put `0 * inf` into the backward pass. As in JAX, a rejected
trial whose stages overflow can still leave `0 * inf = NaN` in the backward
pass through the select.

`checkpoint_steps=True` (JAX's keyword, dopri5.py:184, 269, a
`jax.checkpoint` around each trial step there) runs each chunk of 64 trial
steps under `torch.utils.checkpoint` (non-reentrant): the backward pass
recomputes the chunk from its start instead of keeping its intermediates. It
changes no result, only memory and time. The port defaults to False where
JAX defaults to True: autograd keeps every trial step's intermediates, at the
CLI's batch of 50 patients, D=6 and 256 trial steps (seven stages, the stage
sums and the dense output, some 0.25 MB a step) tens of MB a solve, which an
80 GB card holds, while a recompute would add forward work to every training
step; JAX took the option for a 16 GB TPU.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from . import tableaus

Field = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]

# Step-size controller constants (torchdiffeq's dopri5 regime).
_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0
_ERROR_EXPONENT = -1.0 / 5.0
_CHUNK_SIZE = 64  # trial steps between two host checks of `finished`
_FULL_BUDGET = False  # set by `full_budget()`


@contextlib.contextmanager
def full_budget():
    """Within it, every DOPRI5 solve runs its whole trial budget without reading `finished` on the host.

    The result is the early-exit one, bit for bit (finished rows are frozen
    by the masks); a CUDA graph capture and `torch.func.vmap` need it, since
    neither allows the read.
    """
    global _FULL_BUDGET
    previous, _FULL_BUDGET = _FULL_BUDGET, True
    try:
        yield
    finally:
        _FULL_BUDGET = previous


class Dopri5Stats(NamedTuple):
    n_steps: torch.Tensor  # trial steps taken (per row with per_row=True)
    n_accepted: torch.Tensor  # accepted steps
    success: torch.Tensor  # reached ts[-1] within the budget, all outputs finite
    # False only on the adjoint solver, when a solve accepted more steps than
    # its `max_record` buffer holds (its gradients then leave them out).
    recorded_all: Any = True


class _Tableau(NamedTuple):
    """DOPRI5 coefficients rounded to the state's dtype, as JAX casts them."""

    A: list
    C: list
    B: torch.Tensor
    E: torch.Tensor
    D: torch.Tensor

    @classmethod
    @functools.lru_cache(maxsize=None)
    def make(cls, dtype, device):
        """One tableau per (dtype, device), copied to the device once: a stream being captured
        into a CUDA graph allows no copy from the host."""

        def vec(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        return cls(A=torch.as_tensor(tableaus.DOPRI5_A, dtype=dtype).tolist(),
                   C=torch.as_tensor(tableaus.DOPRI5_C, dtype=dtype).tolist(),
                   B=vec(tableaus.DOPRI5_B), E=vec(tableaus.DOPRI5_E), D=vec(tableaus.DOPRI5_D))


def _rms_norm(x, per_row: bool):
    if per_row:
        return torch.sqrt(torch.mean(torch.square(x), dim=-1, keepdim=True))
    return torch.sqrt(torch.mean(torch.square(x)))


def _initial_step(field: Field, t0, y0, f0, rtol, atol, args, per_row: bool):
    """Hairer's automatic initial step size selection (HNW I.4, alg. 4.14)."""
    scale = atol + torch.abs(y0) * rtol
    d0 = _rms_norm(y0 / scale, per_row)
    d1 = _rms_norm(f0 / scale, per_row)
    h0 = torch.where(torch.minimum(d0, d1) < 1e-5, 1e-6, 0.01 * d0 / torch.clamp(d1, min=1e-30))

    y1 = y0 + h0 * f0
    f1 = field(t0 + h0, y1, args)
    d2 = _rms_norm((f1 - f0) / scale, per_row) / h0

    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15, torch.clamp(h0 * 1e-3, min=1e-6), (0.01 / torch.clamp(dmax, min=1e-30)) ** 0.2)
    return torch.minimum(100.0 * h0, h1)


def _dopri5_step(field: Field, t, y, f0, h, args, tab: _Tableau):
    """One trial step -> (y1, f1, err, k). FSAL: `f0` is stage 1, the returned `f1` stage 7."""
    ks = [f0]
    for i in range(1, 7):
        acc = ks[0] * tab.A[i][0]
        for j in range(1, i):
            acc = acc + ks[j] * tab.A[i][j]
        yi = y + h * acc
        ks.append(field(t + tab.C[i] * h, yi, args))
    k = torch.stack(ks)  # (7, *y.shape)
    y1 = y + h * torch.tensordot(tab.B, k, dims=1)
    err = h * torch.tensordot(tab.E, k, dims=1)
    return y1, ks[6], err, k


def _noise_floor(dtype, rtol):
    """(10 eps, rtol + 10 eps) formed in numpy at the state's precision, as JAX forms them."""
    floor = 10.0 * np.finfo(getattr(np, str(dtype).removeprefix("torch."))).eps
    return float(floor), float(rtol + floor)


def _error_norm(err, y0, y1, atol, floors, h, k_mag, per_row: bool):
    """Scaled RMS error with the float noise floor of hybridode/solvers/dopri5.py:115-135.

    In float32 the embedded error estimate bottoms out at rounding noise, and
    a controller asked for rtol=1e-7 chases that noise and collapses the step
    size. Two terms widen the scale: ~10 eps relative on the state, and ~10
    eps * h * max|k| for the rounding of the cancelling stage sum.
    """
    floor, rtol_floor = floors
    scale = atol + rtol_floor * torch.maximum(torch.abs(y0), torch.abs(y1)) + floor * h * k_mag
    return _rms_norm(err / scale, per_row)


def _dense_coeffs(y0, y1, h, k, tab: _Tableau):
    """Continuous-extension coefficients of one step (Hairer's DOPRI5)."""
    dy = y1 - y0
    bspl = h * k[0] - dy
    return y0, dy, bspl, dy - h * k[6] - bspl, h * torch.tensordot(tab.D, k, dims=1)


def _dense_eval(coeffs, theta):
    """The dense polynomial at `theta` in [0, 1]; theta broadcasts to (T, *y.shape)."""
    r1, r2, r3, r4, r5 = coeffs
    th1 = 1.0 - theta
    return r1 + theta * (r2 + th1 * (r3 + theta * (r4 + th1 * r5)))


def _next_h(h, norm, accept):
    factor = torch.where(norm == 0.0, _MAX_FACTOR,
                         torch.clamp(_SAFETY * norm**_ERROR_EXPONENT, _MIN_FACTOR, _MAX_FACTOR))
    # On rejection never allow growth.
    factor = torch.where(accept, factor, torch.clamp(factor, max=1.0))
    return h * factor


def _grid_theta(ts_b, t, h):
    """Each grid point's place in the step [t, t + h], clamped to [0, 1]."""
    return torch.clamp((ts_b - t) / torch.clamp(h, min=1e-30), 0.0, 1.0)


class Solve(NamedTuple):
    """What every trial step of one solve shares."""

    field: Field
    args: Any
    ts_b: torch.Tensor  # the grid, shaped (T, 1, ..., 1) against (T, *y.shape)
    t_final: torch.Tensor
    tab: _Tableau
    floors: tuple
    atol: float
    barriers: Optional[torch.Tensor]
    per_row: bool


def start(field: Field, y0, ts, args, rtol, atol, barriers=None, per_row=False):
    """Set up a solve -> (its `Solve`, the carry (t, y, f, h, out, n_trial, n_acc, finished) before the first step).

    The first field evaluation keeps its graph; the initial step size is
    computed without gradient. Raises when the field's output does not have
    the state's shape (a per-row argument of shape (B,) against a (B, 1)
    time or a (B, 1) state broadcasts to (B, B)).
    """
    dtype, device = y0.dtype, y0.device
    ts = torch.as_tensor(ts, dtype=dtype, device=device)
    row_shape = tuple(y0.shape[:-1]) + (1,) if per_row else ()
    if barriers is not None:
        barriers = torch.as_tensor(barriers, dtype=dtype, device=device)
    solve = Solve(field, args, ts.reshape((-1,) + (1,) * y0.ndim), ts[-1], _Tableau.make(dtype, device),
                  _noise_floor(dtype, rtol), atol, barriers, per_row)

    t = ts[0].expand(row_shape)
    f = field(t, y0, args)
    if f.shape != y0.shape:
        raise ValueError(f"the field returned shape {tuple(f.shape)} for a state of shape {tuple(y0.shape)}; "
                         "per-row arguments must broadcast against the (B, 1) time or the (B, D) state")
    with torch.no_grad():
        h = _initial_step(field, t, y0, f.detach(), rtol, atol, args, per_row)

    out = torch.cat([y0[None], torch.full((ts.shape[0] - 1,) + tuple(y0.shape), float("nan"), dtype=dtype,
                                          device=device)])
    counts = [torch.zeros(row_shape, dtype=torch.int32, device=device) for _ in range(2)]
    return solve, (t, y0, f, h, out, *counts, torch.zeros(row_shape, dtype=torch.bool, device=device))


def trial_step(s: Solve, carry, budget: Optional[int] = None):
    """One masked trial step -> (the next carry, (t, h_eff, t_new, y, take) of this step).

    A row is alive until it finishes or, with a `budget`, has taken that
    many trial steps; `take` marks the rows that accepted a step while alive.
    """
    t, y, f, h, out, n_trial, n_acc, finished = carry
    if s.barriers is not None:
        # The next barrier strictly ahead of t (a margin so that a step
        # starting on a barrier is not clipped to zero).
        ahead = s.barriers > t + 1e-6
        next_barrier = torch.amin(torch.where(ahead, s.barriers, float("inf")), dim=-1, keepdim=s.per_row)
        h = torch.minimum(h, torch.clamp(next_barrier - t, min=1e-6))

    last_step = h >= s.t_final - t
    h_eff = torch.where(last_step, s.t_final - t, h)
    y1, f1, err, k = _dopri5_step(s.field, t, y, f, h_eff, s.args, s.tab)
    with torch.no_grad():
        k_mag = torch.maximum(torch.abs(k[0]), torch.abs(k[6]))
        norm = _error_norm(err, y, y1, s.atol, s.floors, h_eff, k_mag, s.per_row)
        accept = (norm <= 1.0) & torch.isfinite(norm)
        t_new = torch.where(last_step, s.t_final, t + h_eff)
        # Every grid point this step crosses, from the dense polynomial.
        theta = _grid_theta(s.ts_b, t, h_eff)
        alive = ~finished if budget is None else ~finished & (n_trial < budget)
        do_fill = (s.ts_b > t) & (s.ts_b <= t_new) & accept & alive
        h_next = _next_h(h_eff, norm, accept)
    out = torch.where(do_fill, _dense_eval(_dense_coeffs(y, y1, h_eff, k, s.tab), theta), out)

    take = accept & alive
    carry = (
        torch.where(take, t_new, t),
        torch.where(take, y1, y),
        torch.where(take, f1, f),
        torch.where(alive, h_next, h),
        out,
        n_trial + alive.to(torch.int32),
        n_acc + take.to(torch.int32),
        finished | (take & last_step),
    )
    return carry, (t, h_eff, t_new, y, take)


def integrate(s: Solve, carry, max_steps: int, budget: Optional[int] = None, on_step=None,
              checkpoint_steps: bool = False):
    """Trial steps in chunks of 64 until every row is done -> the last carry.

    A row is done when it has finished or spent its `budget`. Done rows are
    frozen by the masks, so stopping at a chunk boundary gives what the full
    ceil(max_steps / 64) * 64 steps give. Inside `full_budget()` all of them
    run and nothing is read on the host. `on_step` gets each step's record.
    With `checkpoint_steps` (and grad mode on) each chunk runs under
    `torch.utils.checkpoint`, non-reentrant: its backward recomputes it.
    """

    def chunk(*carry):
        for _ in range(_CHUNK_SIZE):
            carry, rec = trial_step(s, carry, budget)
            if on_step is not None:
                on_step(rec)
        return carry

    checkpointed = checkpoint_steps and torch.is_grad_enabled()
    for _ in range(max(1, -(-max_steps // _CHUNK_SIZE))):
        done = carry[-1] if budget is None else carry[-1] | (carry[5] >= budget)
        if not _FULL_BUDGET and bool(done.all()):  # the one host sync of a chunk
            break
        carry = (torch.utils.checkpoint.checkpoint(chunk, *carry, use_reentrant=False) if checkpointed
                 else chunk(*carry))
    return carry


def finish(s: Solve, carry):
    """-> (ys, stats) of a finished carry; per-row stats have the rows' shape."""
    _, _, _, _, out, n_trial, n_acc, finished = carry
    finite = torch.isfinite(out)
    if s.per_row:
        n_trial, n_acc, finished = n_trial[..., 0], n_acc[..., 0], finished[..., 0]
        finite = finite.all(dim=-1).all(dim=0)
    else:
        finite = finite.all()
    return out, Dopri5Stats(n_steps=n_trial, n_accepted=n_acc, success=finished & finite)


def replay_step(s: Solve, t, y, h):
    """An accepted step recomputed from its start, its first stage included -> (y1, its dense output on the grid)."""
    f0 = s.field(t, y, s.args)
    y1, _, _, k = _dopri5_step(s.field, t, y, f0, h, s.args, s.tab)
    return y1, _dense_eval(_dense_coeffs(y, y1, h, k, s.tab), _grid_theta(s.ts_b, t, h))


def odeint_dopri5(
    field: Field,
    y0: torch.Tensor,
    ts,
    args: Any = None,
    *,
    rtol: float = 1e-7,
    atol: float = 1e-8,
    max_steps: int = 256,
    checkpoint_steps: bool = False,
    barriers=None,
    per_row: bool = False,
):
    """Integrate `dy/dt = field(t, y, args)`; return `(ys, stats)`.

    `ys` has shape `(len(ts), *y0.shape)` with `ys[0] == y0`; grid points never
    reached within the budget are NaN, and `stats.success` is False there.
    `barriers`: optional sorted times that steps may not cross (they may start
    on one), for forcing with jumps at known times. With `per_row=True` every
    row of `y0` (all axes but the last) is its own solve.
    `checkpoint_steps=True` recomputes each chunk of 64 trial steps in the
    backward pass instead of keeping it (`torch.utils.checkpoint`): the same
    result and gradients in less memory. Default False, unlike JAX's True (the
    module docstring says why).
    """
    s, carry = start(field, y0, ts, args, rtol, atol, barriers, per_row)
    return finish(s, integrate(s, carry, max_steps, checkpoint_steps=checkpoint_steps))
