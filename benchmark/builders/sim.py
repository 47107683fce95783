"""The program's simulation LHM (configuration kind `sim`), built as `run_simulation` builds it."""

from __future__ import annotations

import math
import os

import torch


def cohort(cfg: dict, root: str, device):
    from hybridode_torch.data import SyntheticCohort

    return SyntheticCohort.load(os.path.join(root, cfg["cohort"]["path"]), device=device)


def model(cfg: dict, method: dict | None = None):
    """`common.build_sim_model` with the configuration's method, solver, tolerances and step control;
    `method` ({"ode_method", "ode_step_size"}) replaces the decoder's solve."""
    from hybridode_torch.cli import common
    from hybridode_torch.config import DataConfig

    data = DataConfig(obs_dim=cfg["obs_dim"], latent_dim=cfg["latent_dim"], action_dim=cfg["action_dim"],
                      t_max=cfg["t_max"], step_size=cfg["step_size"])
    vi = common.build_sim_model(cfg["method"], data, mc_size=cfg["mc_size"], max_steps=cfg["max_steps"],
                                rtol=cfg["rtol"], atol=cfg["atol"],
                                ode_method=(method or {}).get("ode_method", cfg["ode_method"]),
                                lockstep=cfg["step_control"] == "lockstep")
    if method and method.get("ode_step_size"):
        vi = vi._replace(decoder_spec=vi.decoder_spec._replace(ode_step_size=method["ode_step_size"]))
    return vi


@torch.no_grad()
def window_probe(params, vi, data, rows, eps) -> dict:
    """The trial steps each patient of `rows` (the window's last batch) needs, from the program's Dopri5Stats of
    one eager decode at the window's final parameters, and the trial steps the captured step runs for every
    patient (`max_steps` in whole chunks)."""
    from hybridode_torch.fields import doses_from_actions, roche_field
    from hybridode_torch.inference import elbo
    from hybridode_torch.models import priors
    from hybridode_torch.solvers import dopri5, odeint_dopri5

    batch = {k: v.index_select(1, rows) for k, v in data._fold("train").items()}
    mu, log_var = elbo.encode(params, vi, batch["measurements"], batch["actions"], batch["masks"])
    z = priors.gaussian_reparameterize(mu, log_var, eps)
    spec = vi.decoder_spec
    ts = torch.as_tensor(spec.ts, device=z.device)
    _, stats = odeint_dopri5(roche_field, z, ts, (params["decoder"]["ode"],
                                                  doses_from_actions(batch["actions"], spec.step_size)),
                             rtol=spec.rtol, atol=spec.atol, max_steps=spec.max_steps, per_row=True)
    return {"dopri5_program_trials": stats.n_steps.double().cpu().tolist(),
            "dopri5_budget": dopri5._CHUNK_SIZE * math.ceil(spec.max_steps / dopri5._CHUNK_SIZE)}
