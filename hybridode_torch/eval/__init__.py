from .metrics import bootstrap_rmse, crps_ensemble, evaluate

__all__ = ["bootstrap_rmse", "crps_ensemble", "evaluate"]
