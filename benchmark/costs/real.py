"""FLOPs of the ICU-cohort LHM (configuration kind `real`), by the conventions of `benchmark/costs`."""

from __future__ import annotations

from . import linear, lstm_step


def field(cfg: dict) -> int:
    """One evaluation of the ICU field a row: the depot sum over every hour, the two expert nets, the closed-form
    terms and the GRU remainder."""
    hours, fh, ml = cfg["t_max"], cfg["field_hidden_dim"], cfg["latent_dim"] - cfg["expert_dim"]
    dose = hours * cfg["action_dim"] * 7
    nets = linear(3, fh) + fh + linear(fh, 1) + 1 + linear(2, fh) + fh + linear(fh, 1) + 1
    gru = 3 * linear(ml, ml, bias=False) + 3 * ml + 4 * ml
    return dose + nets + 1 + 3 + gru


def forward(cfg: dict) -> float:
    """One patient: the encoder over hours [0, t0), its heads at the last, AB4 over the forecast grid at
    `ode_step_div` steps an hour (RK4 for the first three), the ELU head and the masked squared error."""
    t0, d, obs, hid = cfg["t0"], cfg["latent_dim"], cfg["obs_dim"], cfg["encoder_hidden_dim"]
    n_in = obs + cfg["action_dim"] + cfg["static_dim"] + 1
    heads = 2 * (linear(hid, hid + 1) + (hid + 1) + linear(hid + 1, d) + d)
    points = int(round((cfg["t_max"] - (t0 - 1)) / cfg["step_size"]))  # the grid from t0 - 1
    steps = (points - 1) * cfg["ode_step_div"]
    f = field(cfg)
    solve = (steps + 3 * 3) * f + (steps - 3) * 9 * d + 3 * 17 * d
    head = (points - 1) * (linear(d, d + 1) + 2 * (d + 1) + linear(d + 1, obs))
    return t0 * lstm_step(n_in, hid) + heads + solve + head + 4 * (points - 1) * obs


def step_forward(cfg: dict, trials: float | None) -> float:
    """The training loss of one patient (no adaptive solve: `trials` is not read)."""
    return forward(cfg)


def validation_forward(cfg: dict, mix: dict, trials: float | None) -> float:
    """The validation of one patient: the same masked error."""
    return forward(cfg)
