"""Plain ODE solvers of the reference: per-patient DOPRI5, RK4 and Adams-Bashforth 4 on a fixed grid.

`dopri5_rows` is Dormand and Prince's 5(4) pair with Hairer's initial step
and dense output (Hairer, Norsett and Wanner, "Solving Ordinary Differential
Equations I", II.4-II.6), one controller for each row of a (B, D) state. A
row's rejected trials change nothing of it; gradients flow through the
accepted steps' arithmetic and the selects that pick them, and not through
the step-size control. It runs until every row has reached the end of the
grid, and reports each row's trial steps: the steps that row needs at the
tolerances asked, whatever budget a caller would give it.
"""

from __future__ import annotations

import torch

C = [0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0]
A = [[], [1 / 5], [3 / 40, 9 / 40], [44 / 45, -56 / 15, 32 / 9],
     [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
     [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
     [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]]
B5 = A[6] + [0.0]
E = [71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200, 22 / 525, -1 / 40]
DENSE = [-12715105075 / 11282082432, 0.0, 87487479700 / 32700410799, -10690763975 / 1880347072,
         701980252875 / 199316789632, -1453857185 / 822651844, 69997945 / 29380423]
SAFETY, MIN_FACTOR, MAX_FACTOR = 0.9, 0.2, 10.0
MAX_TRIALS = 10_000  # a safety stop: a row still running here keeps NaN where it did not reach


def _rms(x):
    return torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True))


def _combine(weights, ks):
    out = None
    for w, k in zip(weights, ks):
        if w:
            out = k * w if out is None else out + k * w
    return out


def dopri5_rows(field, y0, ts, rtol, atol):
    """Solve dy/dt = field(t (B, 1), y (B, D)) for each row on its own -> (ys (T, B, D), trial steps (B,))."""
    rows = y0.shape[0]
    t_end = ts[-1]
    t = ts[0].expand(rows, 1).clone()
    y, f = y0, field(ts[0].expand(rows, 1), y0)
    with torch.no_grad():  # Hairer's initial step
        scale = atol + torch.abs(y0) * rtol
        d0, d1 = _rms(y0 / scale), _rms(f / scale)
        h0 = torch.where(torch.minimum(d0, d1) < 1e-5, 1e-6, 0.01 * d0 / torch.clamp(d1, min=1e-30))
        f1 = field(t + h0, y0 + h0 * f)
        d2 = _rms((f1 - f) / scale) / h0
        dmax = torch.maximum(d1, d2)
        h1 = torch.where(dmax <= 1e-15, torch.clamp(h0 * 1e-3, min=1e-6), (0.01 / torch.clamp(dmax, min=1e-30)) ** 0.2)
        h = torch.minimum(100 * h0, h1)
    grid = ts[:, None, None]
    out = torch.cat([y0[None], torch.full((ts.shape[0] - 1,) + tuple(y0.shape), float("nan"), dtype=y0.dtype,
                                          device=y0.device)])
    done = torch.zeros((rows, 1), dtype=torch.bool, device=y0.device)
    trials = torch.zeros(rows, dtype=torch.int64, device=y0.device)
    for _ in range(MAX_TRIALS):
        if bool(done.all()):
            break
        last = h >= t_end - t
        step = torch.where(last, t_end - t, h)
        ks = [f]
        for i in range(1, 7):
            ks.append(field(t + C[i] * step, y + step * _combine(A[i], ks)))
        y1 = y + step * _combine(B5, ks)
        with torch.no_grad():
            err = step * _combine(E, ks)
            scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y1))
            norm = _rms(err / scale)
            accept = (norm <= 1.0) & torch.isfinite(norm) & ~done
            t_new = torch.where(last, t_end, t + step)
            theta = torch.clamp((grid - t) / torch.clamp(step, min=1e-30), 0.0, 1.0)  # finished rows: step 0
            fill = (grid > t) & (grid <= t_new) & accept
            factor = torch.where(norm == 0, MAX_FACTOR, torch.clamp(SAFETY * norm ** -0.2, MIN_FACTOR, MAX_FACTOR))
            factor = torch.where(accept | done, factor, torch.clamp(factor, max=1.0))
        dy = y1 - y
        r3 = step * ks[0] - dy
        r4 = dy - step * ks[6] - r3
        r5 = step * _combine(DENSE, ks)
        dense = y + theta * (dy + (1 - theta) * (r3 + theta * (r4 + (1 - theta) * r5)))
        out = torch.where(fill, dense, out)
        trials = trials + (~done[:, 0]).to(torch.int64)
        t = torch.where(accept, t_new, t)
        y = torch.where(accept, y1, y)
        f = torch.where(accept, ks[6], f)
        h = torch.where(done, h, step * factor)
        # A row whose error is not finite never gets a step accepted: it stops, with NaN where it did not reach.
        done = done | (accept & last) | ~torch.isfinite(norm)
    return out, trials


def rk4(field, y0, ts, n_sub):
    """Classic RK4 with `n_sub` equal steps an interval of `ts`; field(t (scalar tensor), y)."""
    y, out = y0, [y0]
    for i in range(ts.shape[0] - 1):
        dt = (ts[i + 1] - ts[i]) / n_sub
        for s in range(n_sub):
            t = ts[i] + dt * s
            k1 = field(t, y)
            k2 = field(t + dt / 2, y + dt / 2 * k1)
            k3 = field(t + dt / 2, y + dt / 2 * k2)
            k4 = field(t + dt, y + dt * k3)
            y = y + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        out.append(y)
    return torch.stack(out)


def adams_bashforth4(field, y0, ts, n_sub):
    """4th-order Adams-Bashforth with `n_sub` equal steps an interval of `ts`, its first three steps by RK4."""
    y, out, history = y0, [y0], []
    for i in range(ts.shape[0] - 1):
        dt = (ts[i + 1] - ts[i]) / n_sub
        for s in range(n_sub):
            t = ts[i] + dt * s
            history = [field(t, y)] + history[:3]
            if len(history) == 4:
                f0, f1, f2, f3 = history
                y = y + dt * (55 * f0 - 59 * f1 + 37 * f2 - 9 * f3) / 24
            else:
                k1 = history[0]
                k2 = field(t + dt / 2, y + dt / 2 * k1)
                k3 = field(t + dt / 2, y + dt / 2 * k2)
                k4 = field(t + dt, y + dt * k3)
                y = y + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
        out.append(y)
    return torch.stack(out)
