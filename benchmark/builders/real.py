"""The program's ICU-cohort LHM (configuration kind `real`), built as `run_real` builds it."""

from __future__ import annotations

import os


def cohort(cfg: dict, root: str, device):
    from hybridode_torch.data import RealCohort

    c = cfg["cohort"]
    data = RealCohort(data_path=os.path.join(root, c["path"]), data_type=c["data_type"], val_size=c["val"],
                      test_size=c["test"], device=device)
    data.split_sample()
    return data


def model(cfg: dict, method: dict | None = None):
    """`common.build_real_model` with the configuration's method, solver and steps an hour."""
    from hybridode_torch.cli import common

    return common.build_real_model(cfg["method"], cfg["obs_dim"], cfg["action_dim"], cfg["static_dim"],
                                   cfg["t_max"], cfg["step_size"], encoder_output_dim=cfg["latent_dim"],
                                   ode_method=(method or {}).get("ode_method", cfg["ode_method"]),
                                   ode_step_div=cfg["ode_step_div"], t0=cfg["t0"])
