from .real import RealCohort, make_real_standin
from .synthetic import EXPERT_DIM, SyntheticCohort, add_noise, make_dim_cohort, make_test_cohort, make_train_cohort

__all__ = ["EXPERT_DIM", "RealCohort", "SyntheticCohort", "add_noise", "make_dim_cohort", "make_real_standin",
           "make_test_cohort", "make_train_cohort"]
