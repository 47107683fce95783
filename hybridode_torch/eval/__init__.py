from .metrics import (bootstrap_rmse, crps_ensemble, evaluate, evaluate_ensemble, evaluate_ensemble_horizon,
                      evaluate_horizon)

__all__ = ["bootstrap_rmse", "crps_ensemble", "evaluate", "evaluate_ensemble", "evaluate_ensemble_horizon",
           "evaluate_horizon"]
