"""The ICU-cohort LHM (configuration kind `real`), plain reference.

An LSTM forward in time over [x, doses and statics, t / max(mask)] of the
first t0 hours, tanh MLP heads, a field of two learned expert nets,
closed-form immunity and depot terms and a GRU remainder, solved by
4th-order Adams-Bashforth (RK4 for its first three steps) at `ode_step_div`
steps an hour, an ELU MLP head, and the masked squared error of hours t0..
averaged over patients, which is also its validation (`elbo`). The cohort's
directory holds four pickled numpy arrays; its train fold is what the
validation and test folds leave.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import cohort, solvers
from .nets import linear, linear_layout, lstm, lstm_layout, mlp, mlp_layout


def _check(cfg):
    if (cfg["method"], cfg["ode_method"]) != ("hybrid", "explicit_adams"):
        raise ValueError(f"the reference of kind 'real' is --method hybrid --ode_method explicit_adams, not "
                         f"{cfg['method']} {cfg['ode_method']}")


def layout(cfg: dict) -> tuple[dict, dict]:
    """-> (trainable leaves: name -> (shape, uniform bound), the rate constants, trained from their published
    start: name -> value)."""
    _check(cfg)
    obs, d, hid, fh = cfg["obs_dim"], cfg["latent_dim"], cfg["encoder_hidden_dim"], cfg["field_hidden_dim"]
    n_in = obs + cfg["action_dim"] + cfg["static_dim"] + 1
    ml = d - cfg["expert_dim"]
    leaves = {**lstm_layout("encoder.lstm", n_in, hid), **mlp_layout("encoder.lin", [hid, hid + 1, d]),
              **mlp_layout("encoder.log_var", [hid, hid + 1, d])}
    leaves.update({**mlp_layout("decoder.ode.dx1_net", [3, fh, 1]), **mlp_layout("decoder.ode.dx2_net", [2, fh, 1])})
    for name in ("lin_hr", "lin_hz", "lin_hh"):
        leaves.update(linear_layout(f"decoder.ode.{name}", ml, ml, bias=False))
    leaves.update(mlp_layout("decoder.output", [d, d + 1, obs]))
    consts = {f"decoder.ode.{k}": float(v) for k, v in cfg["trained_constants"].items()}
    return leaves, consts


def trainable(cfg: dict) -> list[str]:
    leaves, consts = layout(cfg)
    return list(leaves) + list(consts)


def arrays(spec: dict, root: str) -> tuple[dict, tuple]:
    """The cohort's directory -> ({key: float32 array (T, N, ...)}, (train, val, test) split)."""
    path, kind = os.path.join(root, spec["path"]), spec["data_type"]
    out = {"measurements": cohort.read_pickle(os.path.join(path, f"array_xt{kind}.pkl")),
           "masks": cohort.read_pickle(os.path.join(path, f"array_xt_mask{kind}.pkl")),
           "actions": cohort.read_pickle(os.path.join(path, f"array_at{kind}.pkl"))}
    out = {k: np.asarray(v, np.float32) for k, v in out.items()}
    statics = np.asarray(cohort.read_pickle(os.path.join(path, "array_x_constant.pkl")), np.float32)
    out["statics"] = np.ascontiguousarray(np.broadcast_to(statics[None], (out["masks"].shape[0],) + statics.shape))
    n = out["masks"].shape[1]
    return out, (n - spec["val"] - spec["test"], spec["val"], spec["test"])


def encode(p, x, a, mask):
    """[x, doses and statics, t / max(mask)] over hours [0, t0) -> mu (B, D)."""
    T, B = mask.shape[0], mask.shape[1]
    t_feat = (torch.arange(T, dtype=x.dtype, device=x.device)[:, None, None] / torch.max(mask)).expand(T, B, 1)
    h = lstm(p, "encoder.lstm", torch.cat([x, a, t_feat], dim=-1))[-1]
    return mlp(p, "encoder.lin", h, 2, final=torch.tanh)


def field(p, actions, expert_dim):
    hours = torch.arange(1, actions.shape[0] + 1, dtype=actions.dtype, device=actions.device)[:, None, None]

    def f(t, y):
        given = t >= hours
        dose = torch.sum(torch.where(given, actions * torch.exp(p["decoder.ode.kel"] * torch.where(given, hours - t,
                                                                                                  0.0)), 0.0),
                         dim=(0, 2))
        d1 = mlp(p, "decoder.ode.dx1_net", y[:, :3], 2, final=torch.tanh)
        d2 = mlp(p, "decoder.ode.dx2_net", y[:, :2], 2, final=torch.tanh)
        d3 = (y[:, 1] * p["decoder.ode.k_immunity"])[:, None]
        d4 = (p["decoder.ode.kel"] * dose - p["decoder.ode.kel2"] * y[:, 3])[:, None]
        h = y[:, expert_dim:]
        r = torch.sigmoid(linear(p, "decoder.ode.lin_hr", h))
        z = torch.sigmoid(linear(p, "decoder.ode.lin_hz", h))
        u = torch.tanh(linear(p, "decoder.ode.lin_hh", r * h))
        return torch.cat([d1, d2, d3, d4, (1 - z) * (u - h)], dim=-1)

    return f


def predict(cfg, p, batch):
    """Encode hours [0, t0) and forecast hours t0.. -> x_hat (T - t0, B, obs)."""
    t0 = cfg["t0"]
    x, mask = batch["measurements"], batch["masks"]
    a = torch.cat([batch["actions"], batch["statics"]], dim=-1)
    mu = encode(p, x[:t0], a[:t0], mask[:t0])
    ts = torch.arange(t0 - 1, cfg["t_max"], cfg["step_size"], dtype=mu.dtype, device=mu.device)
    h = solvers.adams_bashforth4(field(p, batch["actions"], cfg["expert_dim"]), mu, ts, cfg["ode_step_div"])
    return mlp(p, "decoder.output", h, 2, act=torch.nn.functional.elu)[1:]


def masked_error(cfg, p, batch):
    t0 = cfg["t0"]
    x, mask = batch["measurements"], batch["masks"]
    return torch.sum((x[t0:] - predict(cfg, p, batch)) ** 2 * mask[t0:]) / x.shape[1]


def loss(cfg, p, batch, noise):
    """The masked squared error of a batch (no noise) -> (loss, None)."""
    return masked_error(cfg, p, batch), None


def validation(cfg, mix, p, chunk) -> float:
    if mix["val_criterion"] != "elbo":
        raise ValueError(f"the reference of kind 'real' validates by its loss (elbo), not {mix['val_criterion']}")
    return float(masked_error(cfg, p, chunk))
