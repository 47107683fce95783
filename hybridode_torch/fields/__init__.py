from .dose import NO_DOSE_TIME, DoseContext, doses_from_actions, exp_decay_dose, impulse_dose
from .neural import init_neural_field, neural_field
from .roche import FROZEN_KEYS, init_roche_field, roche_field

__all__ = [
    "NO_DOSE_TIME",
    "DoseContext",
    "doses_from_actions",
    "exp_decay_dose",
    "impulse_dose",
    "FROZEN_KEYS",
    "init_neural_field",
    "init_roche_field",
    "neural_field",
    "roche_field",
]
