"""Fixed-step batched integrators: euler / midpoint / rk4 / explicit_adams.

Counterpart of hybridode/solvers/fixed_step.py:28-118. The JAX version scans
over the output grid with an unrolled substep loop; here both are Python
loops over tensors, with the same arithmetic in the same order, so the two
agree to float32 rounding. "explicit_adams" is 4th-order Adams-Bashforth
with an RK4 bootstrap on the first three substeps.

A solve copies nothing from the host once its grid is on the device and its
substep count is given (or its grid sits on the CPU): the AB4 coefficients
are copied to each device once, so a solve can be captured into a CUDA graph.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable

import numpy as np
import torch

from . import tableaus

Field = Callable[[torch.Tensor, torch.Tensor, Any], torch.Tensor]


def _rk_step(field: Field, t, y, dt, args, tableau):
    """One explicit Runge-Kutta step from a (numpy) Butcher tableau."""
    C, A, B = tableau
    ks = []
    for i in range(len(C)):
        acc = None
        for j in range(i):
            if A[i][j] == 0.0:
                continue
            term = ks[j] * float(A[i][j])
            acc = term if acc is None else acc + term
        yi = y if acc is None else y + dt * acc
        ks.append(field(t + float(C[i]) * dt, yi, args))
    out = None
    for i, b in enumerate(B):
        if b == 0.0:
            continue
        term = ks[i] * float(b)
        out = term if out is None else out + term
    return y + dt * out


def _resolve_substeps(ts, step_size, n_substeps):
    """The substeps an interval; only a `step_size` without `n_substeps` reads the grid (from the host
    when it is given as an array, else one read of the device grid)."""
    if n_substeps is not None:
        return int(n_substeps)
    if step_size is None:
        return 1
    grid = ts.cpu().numpy() if isinstance(ts, torch.Tensor) else np.asarray(ts)
    max_dt = float(np.max(np.diff(grid, axis=0)))
    return max(1, int(math.ceil(max_dt / float(step_size) - 1e-9)))


@functools.lru_cache(maxsize=None)
def _ab4_coeffs(dtype, device) -> torch.Tensor:
    return torch.as_tensor(tableaus.AB4_COEFFS, dtype=dtype, device=device)


def odeint_fixed(
    field: Field,
    y0: torch.Tensor,
    ts,
    args: Any = None,
    *,
    method: str = "rk4",
    step_size: float | None = None,
    n_substeps: int | None = None,
):
    """Integrate with a fixed-step method, reporting y at each grid time.

    Each interval `[ts[i], ts[i+1]]` is covered by `n_substeps` equal steps
    (derived from `step_size` against the widest interval when not given),
    so grid points are hit exactly. Returns (len(ts), *y0.shape).

    `ts` is a grid of shape (L,), or (L, N, 1, 1) for N independent solves
    held as the leading slices of a (N, B, D) state, each on its own grid
    (the counterpart of JAX's `vmap` of one solve per slice); the field then
    gets a time of shape (N, 1, 1).
    """
    if method not in ("explicit_adams", *tableaus.FIXED_TABLEAUS):
        raise ValueError(f"unknown fixed-step method {method!r}")
    dtype = y0.dtype
    n_sub = _resolve_substeps(ts, step_size, n_substeps)
    ts = torch.as_tensor(ts, dtype=dtype, device=y0.device)
    adams = method == "explicit_adams"
    tableau = tableaus.FIXED_TABLEAUS["rk4" if adams else method]
    ab = _ab4_coeffs(dtype, y0.device)
    steps = torch.arange(n_sub, dtype=dtype, device=y0.device).reshape((n_sub,) + (1,) * (ts.ndim - 1))

    y = y0
    hist = y0.new_zeros((4,) + tuple(y0.shape))
    count = 0
    ys = [y0]
    for i in range(ts.shape[0] - 1):
        t_lo, t_hi = ts[i], ts[i + 1]
        dt = (t_hi - t_lo) / n_sub
        sub_ts = t_lo + dt * steps
        for s in range(n_sub):
            t = sub_ts[s]
            if not adams:
                y = _rk_step(field, t, y, dt, args, tableau)
                continue
            hist = torch.cat([field(t, y, args)[None], hist[:-1]], dim=0)
            if count >= 3:
                y = y + dt * torch.tensordot(ab, hist, dims=1)
            else:
                y = _rk_step(field, t, y, dt, args, tableau)
            count += 1
        ys.append(y)
    return torch.stack(ys)
