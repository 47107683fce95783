from .nnls import learn_ensemble_weights, nnls, nnls2

__all__ = ["learn_ensemble_weights", "nnls", "nnls2"]
