"""Frozen experiment configurations (counterpart of hybridode/config.py:21-103).

Values are identical to the JAX package's, so both packages run the same
hyperparameter regime.
"""

from __future__ import annotations

import dataclasses

import torch

# float32 throughout, as in the JAX package (hybridode/config.py:18).
DTYPE = torch.float32


@dataclasses.dataclass(frozen=True)
class RocheConfig:
    """13 PK/PD rate constants of the expert dexamethasone model."""

    HillCure: float = 2.0
    HillPatho: float = 2.0
    ec50_patho: float = 1.0
    emax_patho: float = 1.0
    k_dexa: float = 1.0
    k_discure_immunereact: float = 1.0
    k_discure_immunity: float = 1.0
    k_disprog: float = 1.0
    k_immune_disease: float = 1.0
    k_immune_feedback: float = 1.0
    k_immune_off: float = 1.0
    k_immunity: float = 1.0
    kel: float = 1.0

    def as_tuple(self):
        return dataclasses.astuple(self)

    def as_dict(self):
        return dataclasses.asdict(self)


# Canonical field order of the 13 expert parameters (matches RocheConfig).
ROCHE_PARAM_NAMES = tuple(f.name for f in dataclasses.fields(RocheConfig))


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Synthetic cohort configuration."""

    n_sample: int = 1000
    obs_dim: int = 20
    latent_dim: int = 6
    action_dim: int = 1
    t_max: int = 14
    step_size: int = 1
    sparsity: float = 0.5
    output_sparsity: float = 0.5
    output_sigma: float = 0.1
    dose_max: float = 1.0
    p_remove: float = 0.5


# High-dimensional cohort presets.
dim8_config = DataConfig(obs_dim=40, latent_dim=8, output_sparsity=1 - 0.375, output_sigma=0.2, dose_max=10)
dim12_config = DataConfig(obs_dim=80, latent_dim=12, output_sparsity=1 - 0.25, output_sigma=0.2, dose_max=10)


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 0.01
    ode_method: str = "dopri5"
    niters: int = 400
    batch_size: int = 50
    test_freq: int = 10
    shuffle: bool = True
    n_restart: int = 5
    early_stop: int = 10


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    t0: int = 5
