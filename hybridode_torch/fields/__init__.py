from .dose import (
    NO_DOSE_TIME,
    CumDoseContext,
    DoseContext,
    cumulative_dose,
    doses_from_actions,
    exp_decay_dose,
    exp_decay_dose_seq,
    impulse_dose,
)
from .neural import init_neural_field, neural_field
from .real import (
    EXPERT_DIM,
    init_neural_real_2nd_field,
    init_neural_real_field,
    init_roche_real_field,
    neural_real_2nd_field,
    neural_real_field,
    roche_real_field,
)
from .roche import FROZEN_KEYS, init_roche_field, roche_field

__all__ = [
    "NO_DOSE_TIME",
    "DoseContext",
    "CumDoseContext",
    "doses_from_actions",
    "exp_decay_dose",
    "impulse_dose",
    "exp_decay_dose_seq",
    "cumulative_dose",
    "FROZEN_KEYS",
    "init_neural_field",
    "init_roche_field",
    "neural_field",
    "roche_field",
    "EXPERT_DIM",
    "init_roche_real_field",
    "roche_real_field",
    "init_neural_real_field",
    "neural_real_field",
    "init_neural_real_2nd_field",
    "neural_real_2nd_field",
]
