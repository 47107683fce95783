"""Evaluation: masked RMSE, sort-based CRPS, bootstrap SE, horizon curves and two-model ensembles.

Counterpart of hybridode/eval/metrics.py:28-305: `crps_ensemble`,
`bootstrap_rmse`, `_masked_mean_sq_err`, `_eval_chunk` / `evaluate`,
`_horizon_chunk` / `evaluate_horizon` and `_ensemble_chunk` /
`evaluate_ensemble` / `evaluate_ensemble_horizon`, for the simulation track's
posteriors (`kind="sim"` and the flow posterior `kind="flow"`), with the
reference's 4-line CSV tail ("rmse_z0,... / rmse_x,... / cprs_z0,... /
cprs_x,...") printed verbatim.

Where JAX vmaps the `mc_itr` posterior decodes, the port flattens the point
decode and the MC decodes of a chunk into one batch of `(mc_itr + 1) * B`
trajectories: one decode per model and chunk, so one RK4 solve (one kernel
launch on the GPU) per model and chunk. Each trajectory's arithmetic is the
same as in separate decodes.

The noise of a chunk is drawn on the CPU from the caller's generator and then
moved, so a CPU run and a GPU run from one seed decode the same posterior
samples. Per chunk and model the draw order is: for the flow posterior its
point draw (B, D), then the MC draws (MC, B, D); for `kind="sim"` the MC
draws alone (its point is the posterior mean). An ensemble draws member e's
noise, then member m's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..inference.elbo import VIModel, decode, encode
from ..models import encoders, priors


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


def draw_chunk_noise(model: VIModel, mc_itr: int, batch_size: int, generator: torch.Generator, device):
    """One chunk's noise `(eps (MC, B, D), eps_point (B, D) or None)`, drawn on the CPU in the
    module's order (the flow's point draw first) and moved to `device`."""
    D = model.encoder_spec.output_dim
    eps_point = torch.randn((batch_size, D), generator=generator).to(device) if model.kind == "flow" else None
    return torch.randn((mc_itr, batch_size, D), generator=generator).to(device), eps_point


def _chunk_forward(params, model: VIModel, batch, t0: int, eps, eps_point=None):
    """Encode on [0, t0), decode the full horizon from the point latent and the MC latents in one
    decode of (MC + 1) * B latents; -> (z0_hat, x_hat, z_mc, x_mc).

    `kind="sim"`: the point is the posterior mean, the MC latents z = mu + eps * std.
    `kind="flow"`: the point is the flow sample of `eps_point` (B, D), the MC
    latents the flow samples of `eps` (MC, B, D).
    """
    enc = encode(params, model, batch["measurements"][:t0], batch["actions"][:t0], batch["masks"][:t0])
    if model.kind == "flow":
        K = model.encoder_spec.num_flows
        z0_hat = encoders.planar_reparameterize(enc, K, eps_point)[2]
        z_mc = encoders.planar_reparameterize(enc, K, eps)[2]  # (MC, B, D)
    else:
        mu, log_var = enc
        z0_hat, z_mc = mu, priors.gaussian_reparameterize(mu, log_var, eps)
    mc, B, D = eps.shape
    z_all = torch.cat([z0_hat[None], z_mc]).reshape((mc + 1) * B, D)  # the point first, then the draws MC-major
    actions_all = batch["actions"].repeat(1, mc + 1, 1)  # (T, (MC+1)*B, A), in z_all's order
    x_all, _ = decode(params, model, z_all, {"actions": actions_all})
    x_all = x_all.reshape(x_all.shape[0], mc + 1, B, -1)
    x_hat = x_all[:, 0]  # (T, B, obs)
    x_mc = x_all[:, 1:].transpose(0, 1)  # (MC, T, B, obs)
    return z0_hat, x_hat, z_mc, x_mc


def _point_terms(batch, t0: int, expert_dim: int, z0_hat, z_mc, x_hat, x_mc):
    """Per-patient (err_z0, err_x, crps_z0, crps_x) of full-horizon decodes."""
    z0 = batch["latents"][0]
    x_test = batch["measurements"][t0:]
    err_z0 = torch.sum((z0[:, :expert_dim] - z0_hat[:, :expert_dim]) ** 2, dim=1)  # (B,)
    err_x = _masked_mean_sq_err(x_test, x_hat[t0:], batch["masks"][t0:], dims=(0, 2))  # (B,)

    z_samples = torch.movedim(z_mc[:, :, :expert_dim], 0, -1)  # (B, D_e, MC)
    crps_z0 = torch.mean(crps_ensemble(z0[:, :expert_dim], z_samples), dim=1)  # (B,)

    x_samples = torch.movedim(x_mc[:, t0:], 0, -1)  # (T', B, obs, MC)
    crps_x = torch.mean(crps_ensemble(x_test, x_samples), dim=(0, 2))  # (B,)
    return err_z0, err_x, crps_z0, crps_x


def _horizon_terms(batch, t0: int, x_hat, x_mc):
    """Per-step, per-patient (err_x, crps_x), each (T', B), of full-horizon decodes."""
    x_test = batch["measurements"][t0:]
    err_x = _masked_mean_sq_err(x_test, x_hat[t0:], batch["masks"][t0:], dims=(2,))
    crps_x = torch.mean(crps_ensemble(x_test, torch.movedim(x_mc[:, t0:], 0, -1)), dim=2)
    return err_x, crps_x


@torch.no_grad()
def _eval_chunk(params, model: VIModel, batch, t0: int, expert_dim: int, eps, eps_point=None):
    """Per-patient (err_z0, err_x, crps_z0, crps_x) of one test chunk; eps is (MC, B, D)."""
    z0_hat, x_hat, z_mc, x_mc = _chunk_forward(params, model, batch, t0, eps, eps_point)
    return _point_terms(batch, t0, expert_dim, z0_hat, z_mc, x_hat, x_mc)


@torch.no_grad()
def _horizon_chunk(params, model: VIModel, batch, t0: int, eps, eps_point=None):
    """Per-step, per-patient (err_x, crps_x) of one test chunk, each (T', B)."""
    _, x_hat, _, x_mc = _chunk_forward(params, model, batch, t0, eps, eps_point)
    return _horizon_terms(batch, t0, x_hat, x_mc)


@torch.no_grad()
def _ensemble_chunk(params_e, model_e: VIModel, params_m, model_m: VIModel, batch, t0: int, expert_dim: int,
                    w_e, w_m, noise_e, noise_m, horizon: bool = False):
    """One test chunk of the blend w_e * model_e + w_m * model_m; `noise_*` is a member's
    `(eps, eps_point)`. The point terms (z0 from model_e's posterior) or, with `horizon`, the
    per-step terms."""
    z0_e, xh_e, zmc_e, xmc_e = _chunk_forward(params_e, model_e, batch, t0, *noise_e)
    _, xh_m, _, xmc_m = _chunk_forward(params_m, model_m, batch, t0, *noise_m)
    x_hat = xh_e * w_e + xh_m * w_m
    x_mc = xmc_e * w_e + xmc_m * w_m  # (MC, T, B, obs)
    if horizon:
        return _horizon_terms(batch, t0, x_hat, x_mc)
    return _point_terms(batch, t0, expert_dim, z0_e, zmc_e, x_hat, x_mc)


def _test_chunks(data_generator, batch_size: int, device):
    for chunk in range(data_generator.test_size // batch_size):
        yield {k: v.to(device) for k, v in data_generator.get_split("test", batch_size, chunk).items()}


def _collect(outs, tots: list):
    for acc, out in zip(tots, outs):
        acc.append(out.cpu().numpy())


def _point_scores(err_z0, err_x, crps_z0, crps_x, verbose: bool):
    """The six numbers and the CSV tail from per-patient terms; patients with no observed entry
    (NaN err_x) are dropped."""
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


def _horizon_scores(err_x, crps_x) -> dict:
    """Per-step RMSE and CRPS vectors (and their SEs) from (T', N) terms; NaN entries are skipped."""
    return {
        "rmse_x": np.sqrt(np.nanmean(err_x, axis=1)),
        "rmse_x_sd": np.array([bootstrap_rmse(row[~np.isnan(row)]) for row in err_x]),
        "cprs_x": np.mean(crps_x, axis=1),
        "cprs_x_sd": np.std(crps_x, axis=1) / np.sqrt(crps_x.shape[1]),
    }


def _seeded(generator: Optional[torch.Generator]) -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None else generator


def evaluate(params, model: VIModel, data_generator, batch_size: int, t0: int, mc_itr: int = 50,
             generator: Optional[torch.Generator] = None, verbose: bool = True, device=None):
    """Point + probabilistic metrics over the test fold, with the stdout CSV contract.

    `params` must live on `device`; the noise comes from `generator` (seed 0
    when None). Returns (rmse_z0, rmse_z0_sd, cprs_z0, rmse_x, rmse_x_sd, cprs_x).
    """
    device, generator = resolve_device(device), _seeded(generator)
    tots = [[], [], [], []]
    for batch in _test_chunks(data_generator, batch_size, device):
        noise = draw_chunk_noise(model, mc_itr, batch_size, generator, device)
        _collect(_eval_chunk(params, model, batch, t0, data_generator.expert_dim, *noise), tots)
    return _point_scores(*(np.concatenate(t) for t in tots), verbose)


def evaluate_horizon(params, model: VIModel, data_generator, batch_size: int, t0: int, mc_itr: int = 10,
                     generator: Optional[torch.Generator] = None, device=None) -> dict:
    """Per-time-step RMSE / CRPS vectors over the test fold past t0: a dict of numpy arrays
    `rmse_x`, `rmse_x_sd`, `cprs_x`, `cprs_x_sd`, each of length T - t0."""
    device, generator = resolve_device(device), _seeded(generator)
    tots = [[], []]
    for batch in _test_chunks(data_generator, batch_size, device):
        noise = draw_chunk_noise(model, mc_itr, batch_size, generator, device)
        _collect(_horizon_chunk(params, model, batch, t0, *noise), tots)
    return _horizon_scores(*(np.concatenate(t, axis=1) for t in tots))


def _ensemble_chunks(params_e, model_e, params_m, model_m, data_generator, batch_size, t0, mc_itr, weight_expert,
                     weight_ml, generator, device, horizon):
    device, generator = resolve_device(device), _seeded(generator)
    w_e = torch.as_tensor(weight_expert, dtype=torch.float32, device=device)
    w_m = torch.as_tensor(weight_ml, dtype=torch.float32, device=device)
    tots = [[], []] if horizon else [[], [], [], []]
    for batch in _test_chunks(data_generator, batch_size, device):
        noise_e = draw_chunk_noise(model_e, mc_itr, batch_size, generator, device)
        noise_m = draw_chunk_noise(model_m, mc_itr, batch_size, generator, device)
        _collect(_ensemble_chunk(params_e, model_e, params_m, model_m, batch, t0, data_generator.expert_dim, w_e,
                                 w_m, noise_e, noise_m, horizon=horizon), tots)
    return [np.concatenate(t, axis=1 if horizon else 0) for t in tots]


def evaluate_ensemble(params_e, model_e: VIModel, params_m, model_m: VIModel, data_generator, batch_size: int,
                      t0: int, mc_itr: int = 50, weight_expert=1.0, weight_ml=1.0,
                      generator: Optional[torch.Generator] = None, verbose: bool = True, device=None):
    """The weighted two-model ensemble's point + probabilistic metrics, with the CSV contract.

    The weights are scalars or (T, 1, obs) arrays; z0 is scored from model_e.
    Returns the six numbers of `evaluate`.
    """
    terms = _ensemble_chunks(params_e, model_e, params_m, model_m, data_generator, batch_size, t0, mc_itr,
                             weight_expert, weight_ml, generator, device, horizon=False)
    return _point_scores(*terms, verbose)


def evaluate_ensemble_horizon(params_e, model_e: VIModel, params_m, model_m: VIModel, data_generator,
                              batch_size: int, t0: int, mc_itr: int = 10, weight_expert=1.0, weight_ml=1.0,
                              generator: Optional[torch.Generator] = None, device=None) -> dict:
    """Horizon variant of `evaluate_ensemble`: the dict of `evaluate_horizon`.

    Like the JAX package, it aggregates every test chunk (the reference
    returns inside the first).
    """
    terms = _ensemble_chunks(params_e, model_e, params_m, model_m, data_generator, batch_size, t0, mc_itr,
                             weight_expert, weight_ml, generator, device, horizon=True)
    return _horizon_scores(*terms)
