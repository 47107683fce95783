"""Normalizing flows with amortised parameters (counterpart of hybridode/models/flows.py:18-77).

`planar_flow` broadcasts over leading axes: a (mc, B, D) batch of draws goes
through one patient's flow parameters (B, ...) without copying them mc times,
which is what JAX's vmap over keys does for the Monte-Carlo KL. The two
Sylvester flows keep the JAX package's (B, ...) shapes; no path runs them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _tanh_deriv(x):
    return 1.0 - torch.tanh(x) ** 2


def planar_flow(zk, u, w, b):
    """z' = z + u_hat * tanh(w^T z + b); returns (z', log|det J|).

    Shapes: zk (..., D); u (..., D, 1); w (..., 1, D); b (..., 1, 1), the
    leading axes broadcasting. u_hat = u + (softplus(w.u) - 1 - w.u) w / |w|^2
    keeps the flow invertible. PyTorch's softplus returns x above 20 where
    JAX's is exact; the two agree to float32 rounding there.
    """
    zk3 = zk[..., None]  # (..., D, 1)

    uw = torch.einsum("...od,...do->...o", w, u)[..., None]  # (..., 1, 1)
    m_uw = -1.0 + F.softplus(uw)
    w_norm_sq = torch.sum(w**2, dim=-1, keepdim=True)  # (..., 1, 1)
    u_hat = u + (m_uw - uw) * w.transpose(-1, -2) / w_norm_sq

    wzb = torch.einsum("...od,...do->...o", w, zk3)[..., None] + b  # (..., 1, 1)
    z = (zk3 + u_hat * torch.tanh(wzb))[..., 0]

    psi = w * _tanh_deriv(wzb)  # (..., 1, D)
    log_det = torch.log(torch.abs(1.0 + torch.einsum("...od,...do->...o", psi, u_hat)))
    return z, log_det[..., 0]


def sylvester_flow(zk, r1, r2, q_ortho, b, sum_ldj: bool = True):
    """z' = z + Q R1 tanh(R2 Q^T z + b).

    Shapes: zk (B, D); r1, r2 (B, M, M); q_ortho (B, D, M); b (B, 1, M).
    """
    zk1 = zk[:, None, :]  # (B, 1, D)
    diag_r1 = torch.diagonal(r1, dim1=-2, dim2=-1)
    diag_r2 = torch.diagonal(r2, dim1=-2, dim2=-1)

    qr2 = torch.einsum("bdm,bnm->bdn", q_ortho, r2)  # (B, D, M)
    qr1 = torch.einsum("bdm,bmn->bdn", q_ortho, r1)  # (B, D, M)

    r2qzb = torch.einsum("bod,bdm->bom", zk1, qr2) + b  # (B, 1, M)
    z = (torch.einsum("bom,bdm->bod", torch.tanh(r2qzb), qr1) + zk1)[:, 0, :]

    diag_j = _tanh_deriv(r2qzb)[:, 0, :] * diag_r1 * diag_r2 + 1.0
    log_diag_j = torch.log(torch.abs(diag_j))
    return z, (torch.sum(log_diag_j, dim=-1) if sum_ldj else log_diag_j)


def triangular_sylvester_flow(zk, r1, r2, b, permute_z=None, sum_ldj: bool = True):
    """Sylvester flow with Q a permutation (`permute_z`, an index array) or the identity."""
    zk1 = zk[:, None, :]
    diag_r1 = torch.diagonal(r1, dim1=-2, dim2=-1)
    diag_r2 = torch.diagonal(r2, dim1=-2, dim2=-1)

    z_per = zk1[:, :, permute_z] if permute_z is not None else zk1

    r2qzb = torch.einsum("bod,bnd->bon", z_per, r2) + b
    z = torch.einsum("bon,bdn->bod", torch.tanh(r2qzb), r1)
    if permute_z is not None:
        z = z[:, :, permute_z]
    z = (z + zk1)[:, 0, :]

    diag_j = _tanh_deriv(r2qzb)[:, 0, :] * diag_r1 * diag_r2 + 1.0
    log_diag_j = torch.log(torch.abs(diag_j))
    return z, (torch.sum(log_diag_j, dim=-1) if sum_ldj else log_diag_j)
