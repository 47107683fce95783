"""Evaluation: masked RMSE, sort-based CRPS and bootstrap SE.

Counterpart of `crps_ensemble`, `bootstrap_rmse`, `_masked_mean_sq_err`,
`_eval_chunk` and `evaluate` in hybridode/eval/metrics.py:28-170, with the
reference's 4-line CSV tail ("rmse_z0,... / rmse_x,... / cprs_z0,... /
cprs_x,...") printed verbatim.

Where JAX vmaps the `mc_itr` posterior decodes, the port flattens them into
one batch of `mc_itr * B` trajectories: one RK4 solve (one kernel launch on
the GPU) for the MC decodes of a chunk, plus one for the point decode.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..inference.elbo import VIModel, decode, encode
from ..models import priors


def crps_ensemble(truth: torch.Tensor, samples: torch.Tensor) -> torch.Tensor:
    """Empirical-CDF CRPS with the ensemble on the LAST axis (properscoring's estimator).

    crps = mean_i |x_i - y| - (1/m^2) sum_i (2i + 1 - m) x_(i)
    """
    m = samples.shape[-1]
    abs_err = torch.mean(torch.abs(samples - truth[..., None]), dim=-1)
    sorted_s = torch.sort(samples, dim=-1).values
    coef = (2.0 * torch.arange(m, dtype=samples.dtype, device=samples.device) + 1.0 - m) / (m * m)
    spread = torch.sum(coef * sorted_s, dim=-1)
    return abs_err - spread


def bootstrap_rmse(err_sq: np.ndarray, n_boot: int = 500, rng: Optional[np.random.RandomState] = None) -> float:
    """Bootstrap SE of RMSE over per-sample squared errors, vectorised over resamples."""
    err_sq = np.asarray(err_sq)
    r = rng if rng is not None else np.random
    idx = r.randint(0, len(err_sq), size=(n_boot, len(err_sq)))
    rmse = np.sqrt(np.mean(err_sq[idx], axis=1))
    return float(np.std(rmse))


def _masked_mean_sq_err(x, x_hat, mask, dims):
    """Per-patient masked mean squared error; NaN for a patient with no observed entry."""
    denom = torch.sum(mask, dim=dims)
    num = torch.sum((x - x_hat) ** 2 * mask, dim=dims)
    return torch.where(denom > 0, num / torch.clamp(denom, min=1.0), torch.full_like(num, float("nan")))


def _chunk_forward(params, model: VIModel, batch, t0: int, eps):
    """Encode on [0, t0), decode the full horizon from the posterior mean and from
    the MC draws z = mu + eps * std, eps (MC, B, D)."""
    mu, log_var = encode(params, model, batch["measurements"][:t0], batch["actions"][:t0], batch["masks"][:t0])
    x_hat, _ = decode(params, model, mu, batch)

    mc, B, D = eps.shape
    z_mc = priors.gaussian_reparameterize(mu, log_var, eps)  # (MC, B, D)
    actions_mc = batch["actions"].repeat(1, mc, 1)  # (T, MC*B, A), MC-major like z_mc.reshape
    x_mc, _ = decode(params, model, z_mc.reshape(mc * B, D), {"actions": actions_mc})
    x_mc = x_mc.reshape(x_mc.shape[0], mc, B, -1).transpose(0, 1)  # (MC, T, B, obs)
    return mu, x_hat, z_mc, x_mc


@torch.no_grad()
def _eval_chunk(params, model: VIModel, batch, t0: int, expert_dim: int, eps):
    """Per-patient (err_z0, err_x, crps_z0, crps_x) of one test chunk; eps is (MC, B, D)."""
    z0 = batch["latents"][0]
    z0_hat, x_hat, z_mc, x_mc = _chunk_forward(params, model, batch, t0, eps)

    x_hat = x_hat[t0:]
    x_test = batch["measurements"][t0:]
    mask_test = batch["masks"][t0:]

    err_z0 = torch.sum((z0[:, :expert_dim] - z0_hat[:, :expert_dim]) ** 2, dim=1)  # (B,)
    err_x = _masked_mean_sq_err(x_test, x_hat, mask_test, dims=(0, 2))  # (B,)

    z_samples = torch.movedim(z_mc[:, :, :expert_dim], 0, -1)  # (B, D_e, MC)
    crps_z0 = torch.mean(crps_ensemble(z0[:, :expert_dim], z_samples), dim=1)  # (B,)

    x_samples = torch.movedim(x_mc[:, t0:], 0, -1)  # (T', B, obs, MC)
    crps_x = torch.mean(crps_ensemble(x_test, x_samples), dim=(0, 2))  # (B,)
    return err_z0, err_x, crps_z0, crps_x


def evaluate(params, model: VIModel, data_generator, batch_size: int, t0: int, mc_itr: int = 50,
             generator: Optional[torch.Generator] = None, verbose: bool = True, device=None):
    """Point + probabilistic metrics over the test fold, with the stdout CSV contract.

    `params` must live on `device`. The MC noise is drawn on the CPU from
    `generator` (seed 0 when None) and then moved, so a CPU run and a GPU run
    from one seed decode the same posterior samples.

    Returns (rmse_z0, rmse_z0_sd, cprs_z0, rmse_x, rmse_x_sd, cprs_x).
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    expert_dim = data_generator.expert_dim
    latent = model.encoder_spec.output_dim

    tots = [[], [], [], []]
    for chunk in range(data_generator.test_size // batch_size):
        batch = {k: v.to(device) for k, v in data_generator.get_split("test", batch_size, chunk).items()}
        eps = torch.randn((mc_itr, batch_size, latent), generator=generator).to(device)
        for tot, out in zip(tots, _eval_chunk(params, model, batch, t0, expert_dim, eps)):
            tot.append(out.cpu().numpy())

    err_z0, err_x, crps_z0, crps_x = (np.concatenate(t) for t in tots)
    rmse_z0 = float(np.sqrt(np.mean(err_z0)))
    rmse_z0_sd = bootstrap_rmse(err_z0)

    cprs_z0 = float(np.mean(crps_z0))
    cprs_z0_sd = float(np.std(crps_z0) / np.sqrt(len(crps_z0)))

    err_x = err_x[~np.isnan(err_x)]
    rmse_x = float(np.sqrt(np.mean(err_x)))
    rmse_x_sd = bootstrap_rmse(err_x)

    cprs_x = float(np.mean(crps_x))
    cprs_x_sd = float(np.std(crps_x) / np.sqrt(len(crps_x)))

    if verbose:
        print("rmse_z0,{:.4f},{:.4f}".format(rmse_z0, rmse_z0_sd))
        print("rmse_x,{:.4f},{:.4f}".format(rmse_x, rmse_x_sd))
        print("cprs_z0,{:.4f},{:.4f}".format(cprs_z0, cprs_z0_sd))
        print("cprs_x,{:.4f},{:.4f}".format(cprs_x, cprs_x_sd))

    return rmse_z0, rmse_z0_sd, cprs_z0, rmse_x, rmse_x_sd, cprs_x
