"""The forecast's scores: RMSE and CRPS of the posterior mean and of its Monte-Carlo decodes (plain reference).

For each patient of a request: encode the hours before t0 and decode the
posterior mean and `mc` reparameterised draws over the whole horizon (by
the `encode` and `decode` of the configuration's family), and score the
initial expert states and the observations after t0. The six numbers are
rmse_z0 and its bootstrap standard error, the mean CRPS of z0, rmse_x and
its bootstrap standard error, and the mean CRPS of x; RMSEs are over
patients (a patient with nothing observed after t0 is left out of rmse_x),
the CRPS is the empirical-CDF estimator over the draws, and each bootstrap
draws 500 resamples of the patients from a numpy `RandomState`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import model

N_BOOT = 500


def crps(truth, samples):
    """Empirical-CDF CRPS with the ensemble on the last axis: E|X - y| - E|X - X'| / 2."""
    m = samples.shape[-1]
    spread = torch.abs(samples[..., :, None] - samples[..., None, :]).sum(dim=(-1, -2)) / (2 * m * m)
    return torch.mean(torch.abs(samples - truth[..., None]), dim=-1) - spread


def bootstrap_se(err_sq: np.ndarray, rng: np.random.RandomState) -> float:
    idx = rng.randint(0, len(err_sq), size=(N_BOOT, len(err_sq)))
    return float(np.std(np.sqrt(np.mean(err_sq[idx], axis=1))))


def forecast(cfg, method, p, chunk, t0, eps, np_seed):
    """One request's six numbers and the trial steps each decoded row needed (or None).

    `chunk` is the request's patients (T, B, ...); `eps` (mc, B, D) the draws.
    """
    x, a, mask = chunk["measurements"], chunk["actions"], chunk["masks"]
    mc, B, D = eps.shape
    with torch.no_grad():
        fam = model.family(cfg)
        mu, log_var = fam.encode(p, x[:t0], a[:t0], mask[:t0])
        z_mc = mu + eps * torch.exp(0.5 * log_var)
        x_all, trials = fam.decode(cfg, p, torch.cat([mu[None], z_mc]).reshape((mc + 1) * B, D),
                                   a.repeat(1, mc + 1, 1), method)
        x_all = x_all.reshape(x_all.shape[0], mc + 1, B, -1)
        x_hat, x_mc = x_all[:, 0], x_all[:, 1:]
        e = cfg["expert_dim"]
        z0 = chunk["latents"][0][:, :e]
        err_z0 = torch.sum((z0 - mu[:, :e]) ** 2, dim=1)
        obs = torch.sum(mask[t0:], dim=(0, 2))
        err_x = torch.sum((x[t0:] - x_hat[t0:]) ** 2 * mask[t0:], dim=(0, 2)) / torch.clamp(obs, min=1.0)
        crps_z0 = torch.mean(crps(z0, z_mc[:, :, :e].permute(1, 2, 0)), dim=1)
        crps_x = torch.mean(crps(x[t0:], x_mc[t0:].permute(0, 2, 3, 1)), dim=(0, 2))
    err_z0, crps_z0, crps_x = (v.double().cpu().numpy() for v in (err_z0, crps_z0, crps_x))
    err_x = err_x[obs > 0].double().cpu().numpy()
    rng = np.random.RandomState(np_seed)
    numbers = {"rmse_z0": float(np.sqrt(np.mean(err_z0))), "rmse_z0_sd": bootstrap_se(err_z0, rng),
               "cprs_z0": float(np.mean(crps_z0)), "rmse_x": float(np.sqrt(np.mean(err_x))),
               "rmse_x_sd": bootstrap_se(err_x, rng), "cprs_x": float(np.mean(crps_x))}
    return numbers, trials
