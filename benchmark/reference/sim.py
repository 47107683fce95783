"""The simulation LHM (configuration kind `sim`), plain reference.

A reversed LSTM over the masked observations and the doses, heads
mu = exp(lin(h)) / 10 and log_var = lin(h) - 5, the Roche PK/PD field plus a
Linear+Tanh remainder on the latent, solved by DOPRI5 with each patient's
own step control (or by RK4 at a fixed step), a linear observation head, and
the ELBO: the masked squared error summed over time and features, averaged
over patients, plus a Monte-Carlo KL against an Exponential(100) prior.
Validation is the forecast from t0: the posterior mean of the hours before
it decoded, the masked squared error of the rest over its observed count.
The cohort is a pickled `SyntheticCohort`, which records its own split.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from . import cohort, solvers
from .nets import linear, linear_layout, lstm, lstm_layout, mlp_layout

FLOAT32_EPS = 2.0 ** -23  # the KL's clamp of non-positive draws, a float32 constant in the published code
NO_DOSE = 1e30
ROCHE_NAMES = ("HillCure", "HillPatho", "ec50_patho", "emax_patho", "k_dexa", "k_discure_immunereact",
               "k_discure_immunity", "k_disprog", "k_immune_disease", "k_immune_feedback", "k_immune_off",
               "k_immunity", "kel")


def _check(cfg):
    """This reference is the hybrid model with per-patient step control; anything else needs a family of its own."""
    if (cfg["method"], cfg["step_control"]) != ("hybrid", "per_sample"):
        raise ValueError(f"the reference of kind 'sim' is --method hybrid --step_control per_sample, not "
                         f"{cfg['method']} {cfg['step_control']}")


def layout(cfg: dict) -> tuple[dict, dict]:
    """-> (trainable leaves: name -> (shape, uniform bound), the expert's fixed constants: name -> value)."""
    _check(cfg)
    obs, d, a, hid = cfg["obs_dim"], cfg["latent_dim"], cfg["action_dim"], cfg["encoder_hidden_dim"]
    leaves = {**lstm_layout("encoder.lstm", obs + a, hid), **linear_layout("encoder.lin", hid, d),
              **linear_layout("encoder.log_var", hid, d),
              **mlp_layout("decoder.ode.ml_net", [d, d - cfg["expert_dim"]]),
              **linear_layout("decoder.output", d, obs)}
    consts = {f"decoder.ode.expert.{k}": float(cfg["expert"][k]) for k in ROCHE_NAMES}
    return leaves, consts


def trainable(cfg: dict) -> list[str]:
    return list(layout(cfg)[0])


def arrays(spec: dict, root: str) -> tuple[dict, tuple]:
    """The cohort file -> ({key: float32 array (T, N, ...)}, its own (train, val, test) split)."""
    state = cohort.read_pickle(os.path.join(root, spec["path"]))["state"]
    out = {k: np.asarray(state[k], np.float32) for k in ("measurements", "actions", "latents", "masks")}
    return out, (state["train_size"], state["val_size"], state["test_size"])


def encode(p, x, a, mask):
    """(T, B, obs), (T, B, 1), mask -> (mu, log_var) of the initial latent."""
    y_in = torch.cat([x * mask, a], dim=-1)
    h = lstm(p, "encoder.lstm", y_in, reverse=True)[0]
    return torch.exp(linear(p, "encoder.lin", h)) / 10.0, linear(p, "encoder.log_var", h) - 5.0


def doses(actions, step):
    """(T, B, 1) actions -> (first dose time (B, 1), amount (B, 1)): one bolus a patient, at the earliest
    non-zero action, of the largest action's amount."""
    a = actions[..., 0]
    given = a != 0
    first = torch.argmax(given.to(torch.int64), dim=0).to(a.dtype) * step
    first = torch.where(given.any(dim=0), first, torch.full_like(first, NO_DOSE))
    return first[:, None], a.amax(dim=0)[:, None]


def roche_field(p, dose_time, amount, ml_out):
    """dy/dt of the expert PK/PD model with the learned remainder on the last `ml_out` states; t is (B, 1)."""
    e = {k: p[f"decoder.ode.expert.{k}"] for k in ROCHE_NAMES}

    def field(t, y):
        disease, react, immunity, dose2 = y[:, 0], y[:, 1], y[:, 2], y[:, 3]
        given = t >= dose_time
        dose = torch.where(given, amount * torch.exp(e["kel"] * torch.where(given, dose_time - t, 0.0)),
                           0.0)[:, 0]
        react_hill = torch.abs(react) ** e["HillPatho"]
        d1 = (disease * e["k_disprog"] - disease * torch.abs(immunity) ** e["HillCure"] * e["k_discure_immunity"]
              - disease * react * e["k_discure_immunereact"])
        d2 = (disease * e["k_immune_disease"] - react * e["k_immune_off"] + disease * react * e["k_immune_feedback"]
              + react_hill * e["emax_patho"] / (torch.abs(e["ec50_patho"]) ** e["HillPatho"] + react_hill)
              - dose2 * react * e["k_dexa"])
        d3 = react * e["k_immunity"]
        d4 = e["kel"] * dose - e["kel"] * dose2
        out = [torch.stack([d1, d2, d3, d4], dim=-1)]
        if ml_out:
            out.append(torch.tanh(linear(p, "decoder.ode.ml_net.0", y)))
        return torch.cat(out, dim=-1)

    return field


def decode(cfg, p, z, actions, method):
    """(B, D) initial latents -> (x_hat (T, B, obs), per-patient trial steps or None); `method` is
    {"ode_method", "ode_step_size"}."""
    ts = torch.arange(0.0, cfg["t_max"] + cfg["step_size"], cfg["step_size"], dtype=z.dtype, device=z.device)
    dose_time, amount = doses(actions, cfg["step_size"])
    field = roche_field(p, dose_time, amount, cfg["latent_dim"] - cfg["expert_dim"])
    trials = None
    if method["ode_method"] == "dopri5":
        h, trials = solvers.dopri5_rows(field, z, ts, cfg["rtol"], cfg["atol"])
    else:
        n_sub = max(1, round(cfg["step_size"] / method["ode_step_size"]))
        h = solvers.rk4(lambda t, y: field(t.expand(y.shape[0], 1), y), z, ts, n_sub)
    return linear(p, "decoder.output", h), trials


def loss(cfg, p, batch, noise):
    """The ELBO of a batch, `noise` (eps, eps_kl) -> (loss, per-patient trial steps)."""
    eps, eps_kl = noise
    x, a, mask = batch["measurements"], batch["actions"], batch["masks"]
    mu, log_var = encode(p, x, a, mask)
    std = torch.exp(0.5 * log_var)
    x_hat, trials = decode(cfg, p, mu + eps * std, a, {"ode_method": cfg["ode_method"]})
    lik = torch.sum((x - x_hat) ** 2 * mask) / x.shape[1]
    z = mu + eps_kl * std
    z = torch.where(z <= 0.0, FLOAT32_EPS, z)
    log_q = torch.sum(-0.5 * (math.log(2 * math.pi) + log_var + (z - mu) ** 2 / torch.exp(log_var)), dim=-1)
    rate = cfg["prior_rate"]
    log_prior = torch.sum(math.log(rate) - rate * z, dim=-1)
    return lik + torch.mean(torch.mean(log_q - log_prior, dim=0)), trials


def forecast_terms(cfg, p, batch, t0):
    """The posterior mean of hours [0, t0) decoded -> (masked squared error of the rest, observed count)."""
    x, a, mask = batch["measurements"], batch["actions"], batch["masks"]
    mu, _ = encode(p, x[:t0], a[:t0], mask[:t0])
    x_hat, _ = decode(cfg, p, mu, a, {"ode_method": cfg["ode_method"]})
    return torch.sum((x[t0:] - x_hat[t0:]) ** 2 * mask[t0:]), torch.sum(mask[t0:])


def validation(cfg, mix, p, chunk) -> float:
    """One chunk of the validation fold by the mix's criterion (`forecast`, at `val_t0`)."""
    if mix["val_criterion"] != "forecast":
        raise ValueError(f"the reference of kind 'sim' validates by forecast, not {mix['val_criterion']}")
    num, den = forecast_terms(cfg, p, chunk, mix["val_t0"])
    return float(num / torch.clamp(den, min=1.0))
