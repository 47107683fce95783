from .dose import NO_DOSE_TIME, DoseContext, doses_from_actions, exp_decay_dose
from .roche import FROZEN_KEYS, init_roche_field, roche_field

__all__ = [
    "NO_DOSE_TIME",
    "DoseContext",
    "doses_from_actions",
    "exp_decay_dose",
    "FROZEN_KEYS",
    "init_roche_field",
    "roche_field",
]
