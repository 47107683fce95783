"""FLOPs of the simulation LHM (configuration kind `sim`), by the conventions of `benchmark/costs`."""

from __future__ import annotations

import math

from . import dopri5_trial, linear, lstm_step, roche_field, roche_rk4_kernel


def encoder(cfg: dict, steps: int) -> int:
    """The reversed LSTM over `steps` hours of masked observations and doses, and the two heads, a patient."""
    obs, d, hid = cfg["obs_dim"], cfg["latent_dim"], cfg["encoder_hidden_dim"]
    return steps * (obs + lstm_step(obs + cfg["action_dim"], hid)) + 2 * linear(hid, d) + 3 * d


def points(cfg: dict) -> int:
    return int(round(cfg["t_max"] / cfg["step_size"])) + 1


def decode(cfg: dict, trials: float) -> float:
    """A row's DOPRI5 solve of `trials` trial steps (plus its initial step and dense output at the grid) and the
    observation head at every grid point."""
    d, grid = cfg["latent_dim"], points(cfg)
    field = roche_field(d, cfg["expert_dim"])
    return (trials * dopri5_trial(d, field) + 2 * field + 20 * d + (grid - 1) * 9 * d
            + grid * linear(d, cfg["obs_dim"]))


def step_forward(cfg: dict, trials: float | None) -> float | None:
    """The ELBO of one patient: encoder, draw, decode, masked squared error and the Monte-Carlo KL."""
    if trials is None:
        return None
    d, grid, mc = cfg["latent_dim"], points(cfg), cfg["mc_size"]
    return encoder(cfg, grid) + 3 * d + decode(cfg, trials) + 4 * grid * cfg["obs_dim"] + mc * d * 14 + 2 * mc


def validation_forward(cfg: dict, mix: dict, trials: float | None) -> float | None:
    """The forecast validation of one patient: encoder over [0, t0), the mean's decode, the error after t0."""
    if trials is None:
        return None
    grid, t0 = points(cfg), mix["val_t0"]
    return encoder(cfg, t0) + decode(cfg, trials) + 4 * (grid - t0) * cfg["obs_dim"]


def forecast_request(cfg: dict, mix: dict, trials: float | None) -> float | None:
    """One request: the encoder over [0, t0) for each patient, the decode of the mean and `mc_itr` draws of each
    (DOPRI5 at the needed trial steps, or RK4), and the scores on the device: the squared errors and the CRPS
    (its sort counted as m log2 m, its sums 5 m per element)."""
    B, mc, t0 = mix["patients_per_request"], mix["mc_itr"], mix["t0"]
    d, obs, grid = cfg["latent_dim"], cfg["obs_dim"], points(cfg)
    rows = (mc + 1) * B
    if mix["ode_method"] == "rk4":
        n_sub = max(1, round(cfg["step_size"] / mix["ode_step_size"]))
        dec = roche_rk4_kernel(rows, d, grid, n_sub)[0] + rows * grid * linear(d, obs)
    elif trials is None:
        return None
    else:
        dec = rows * decode(cfg, trials)
    elements = B * (cfg["expert_dim"] + (grid - t0) * obs)
    crps = elements * (mc * math.log2(mc) + 5 * mc)
    scores = B * (3 * cfg["expert_dim"] + 4 * (grid - t0) * obs)
    return B * (encoder(cfg, t0) + 3 * d * mc) + dec + crps + scores
