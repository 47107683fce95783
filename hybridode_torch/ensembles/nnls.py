"""Non-negative least squares for the ensemble pipelines (counterpart of hybridode/ensembles/nnls.py:19-117).

The ensembles only ever solve 2-variable problems (an expert weight and an
ml weight per time step): `nnls2` solves them in closed form, batched over
the time steps, on tensors. `nnls` is a dense Lawson-Hanson active-set solver
on the host (numpy), with scipy.optimize.nnls's contract.
"""

from __future__ import annotations

import numpy as np
import torch


def nnls2(a1, a2, b):
    """Exact 2-variable NNLS, batched over leading axes.

    Solves min_{w >= 0} ||w1*a1 + w2*a2 - b||^2 for a1, a2, b of shape
    (..., n); returns (w1, w2) of shape (...). The unconstrained 2x2 normal
    equations' solution where it is feasible, else the better single-variable
    projection: exhaustive over the active sets of two variables, so exact.
    """
    a11 = torch.sum(a1 * a1, dim=-1)
    a22 = torch.sum(a2 * a2, dim=-1)
    a12 = torch.sum(a1 * a2, dim=-1)
    b1 = torch.sum(a1 * b, dim=-1)
    b2 = torch.sum(a2 * b, dim=-1)
    one, zero = torch.ones_like(a11), torch.zeros_like(a11)

    det = a11 * a22 - a12 * a12
    safe_det = torch.where(torch.abs(det) < 1e-30, one, det)
    w1_u = (a22 * b1 - a12 * b2) / safe_det
    w2_u = (a11 * b2 - a12 * b1) / safe_det
    feasible = (w1_u >= 0) & (w2_u >= 0) & (torch.abs(det) >= 1e-30)

    # Single-variable candidates.
    w1_s = torch.clamp(b1 / torch.where(a11 < 1e-30, one, a11), min=0.0) * (a11 >= 1e-30)
    w2_s = torch.clamp(b2 / torch.where(a22 < 1e-30, one, a22), min=0.0) * (a22 >= 1e-30)

    # Squared residual up to the constant ||b||^2: r(w) = w'Qw - 2 w'c.
    def obj(w1, w2):
        return w1 * w1 * a11 + w2 * w2 * a22 + 2 * w1 * w2 * a12 - 2 * (w1 * b1 + w2 * b2)

    use_w1 = obj(w1_s, zero) <= obj(zero, w2_s)
    w1_best = torch.where(use_w1, w1_s, zero)
    w2_best = torch.where(use_w1, zero, w2_s)
    return torch.where(feasible, w1_u, w1_best), torch.where(feasible, w2_u, w2_best)


def nnls(A: np.ndarray, b: np.ndarray, max_iter: int | None = None):
    """Dense Lawson-Hanson active-set NNLS on the host; -> (x, rnorm) as scipy.optimize.nnls."""
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    m, n = A.shape
    if max_iter is None:
        max_iter = 3 * n

    x = np.zeros(n)
    passive: set[int] = set()
    w = A.T @ (b - A @ x)
    tol = 1e-12 * np.linalg.norm(A, 1) * max(m, 1)

    def best_free(w):
        return np.where([i not in passive for i in range(n)], w, -np.inf)

    it = 0
    while len(passive) < n and np.max(best_free(w)) > tol:
        passive.add(int(np.argmax(best_free(w))))
        while True:
            it += 1
            if it > max_iter:
                break
            P = sorted(passive)
            s = np.zeros(n)
            s[P] = np.linalg.lstsq(A[:, P], b, rcond=None)[0]
            if np.all(s[P] > tol):
                x = s
                break
            neg = [i for i in P if s[i] <= tol]
            alpha = min(x[i] / (x[i] - s[i]) for i in neg if x[i] != s[i])
            x = x + alpha * (s - x)
            passive = {i for i in P if x[i] > tol}
            if not passive:
                x = np.zeros(n)
                break
        if it > max_iter:
            break
        w = A.T @ (b - A @ x)

    return x, float(np.linalg.norm(A @ x - b))


def learn_ensemble_weights(x, x_hat_e, x_hat_m, t0: int):
    """Per-time-step NNLS ensemble weights over the flattened (B*D) residuals.

    x, x_hat_e, x_hat_m: (T, B, D). Steps before t0 get weight 0. Returns
    (weights_e, weights_m), each (T, 1, D).
    """
    T, B, D = x.shape
    w1, w2 = nnls2(x_hat_e[:T].reshape(T, B * D), x_hat_m[:T].reshape(T, B * D), x.reshape(T, B * D))
    keep = (torch.arange(T, device=x.device) >= t0).to(x.dtype)
    return (w1 * keep)[:, None, None].expand(T, 1, D), (w2 * keep)[:, None, None].expand(T, 1, D)
