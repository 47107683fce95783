from .synthetic import EXPERT_DIM, SyntheticCohort

__all__ = ["EXPERT_DIM", "SyntheticCohort"]
