from .real import RealCohort, make_real_standin
from .synthetic import EXPERT_DIM, SyntheticCohort

__all__ = ["EXPERT_DIM", "RealCohort", "SyntheticCohort", "make_real_standin"]
