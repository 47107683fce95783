"""Synthetic PK/PD cohorts: generation, loading and fold splits.

Counterpart of hybridode/data/synthetic.py. Generation (`SyntheticCohort`
:40-188, `make_train_cohort`, `make_test_cohort`, `make_dim_cohort` and
`add_noise` :260-313): a host `numpy.random.RandomState` makes every draw, in
the JAX generator's calls and order (the observation head, the ml mixing, the
initial latents, one `rng.choice` a patient for its dose time, the dose
amounts, then the measurement noise after the solve and the masks last), so
one seed gives the JAX package's arrays byte for byte, the latents apart. The
latents are one float64 lockstep DOPRI5 solve of the whole cohort
(`odeint_dopri5`, rtol 1e-8, atol 1e-10) of the port's `roche_field` with
the ml coefficients as the `ml_net` weights, on the cohort's device: the GPU
unless the caller asks for the CPU. They agree with JAX's to ~1 float32 ulp
(on the GPU the lockstep controller takes another step sequence: its error
norm sums in another order, and the dose jumps make the steps sensitive to
that; the latents stay within the same tolerance). `backend="native"` solves
them instead with the port's copy of the JAX package's C++ integrator
(`hybridode_torch/native`, one float64 DOPRI5 a patient on the host), as
JAX's `backend="native"` does; a failed build raises with g++'s output.

`save` writes the JAX package's payload, `{"class": "SyntheticCohort",
"state": ...}`, naming JAX's classes (`utils/pickling.py`), so that either
package loads either package's files.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import RocheConfig
from ..fields import DoseContext, roche_field
from ..solvers import odeint_dopri5
from ..utils.pickling import load_pickle, save_pickle

EXPERT_DIM = 4
# The dtype a cohort records for its float arrays (JAX's `jax.numpy.float32`).
DTYPE = np.float32


class SyntheticCohort:
    """Holds the (T, B, D) cohort arrays and float32 fold tensors on `device`."""

    _KEYS = ("measurements", "actions", "latents", "masks")

    def __init__(
        self,
        n_sample: int,
        obs_dim: int,
        t_max: float,
        step_size: float,
        roche_config: RocheConfig,
        output_sigma: float,
        dose_max: float = 0.0,
        latent_dim: int = 4,
        sparsity: float = 0.5,
        output_sparsity: float = 0.0,
        val_size: int = 100,
        test_size: int = 200,
        p_remove: float = 0.0,
        rng: Optional[np.random.RandomState] = None,
        dtype=DTYPE,
        device=None,
    ):
        self.device = resolve_device(device)
        self.rng = rng if rng is not None else np.random.RandomState()
        self.dtype = dtype

        self.n_sample = n_sample
        self.obs_dim = obs_dim
        self.latent_dim = int(latent_dim)
        self.expert_dim = EXPERT_DIM
        self.ml_dim = self.latent_dim - self.expert_dim
        self.sparsity = sparsity
        self.action_dim = 1
        self.t_max = t_max
        self.step_size = step_size
        self.time_dim = int(t_max / step_size + 1)
        self.roche_config = roche_config
        self.dose_max = dose_max
        self.p_remove = p_remove
        self.output_sparsity = output_sparsity
        self.output_sigma = output_sigma

        # Random sparse observation head and ml mixing.
        self.output_coef = self.rng.randn(obs_dim, self.latent_dim + self.action_dim) * self.rng.binomial(
            1, 1 - self.output_sparsity, (obs_dim, self.latent_dim + self.action_dim)
        )
        self.ml_coef = (
            self.rng.randn(self.latent_dim, self.ml_dim)
            * self.rng.binomial(1, 1 - self.sparsity, (self.latent_dim, self.ml_dim))
            / self.latent_dim
        )

        self.val_size = int(val_size)
        self.test_size = int(test_size)
        self.train_size = int(n_sample - val_size - test_size)

        self.measurements = None
        self.actions = None
        self.latents = None
        self.masks = None
        self.data_train, self.data_val, self.data_test = None, None, None

    # --- generation ---------------------------------------------------------

    def _ground_truth_params(self) -> dict:
        """The Roche field's parameters in float64, with the ml coefficients as the remainder's weights."""
        f64 = dict(dtype=torch.float64, device=self.device)
        params = {"expert": {k: torch.tensor(float(v), **f64) for k, v in self.roche_config.as_dict().items()}}
        if self.ml_dim > 0:
            params["ml_net"] = [{"w": torch.as_tensor(self.ml_coef, **f64), "b": torch.zeros((self.ml_dim,), **f64)}]
        return params

    def get_initial_conditions(self):
        """Exp(scale=0.01) initial latents."""
        return self.rng.exponential(scale=0.01, size=(self.n_sample, self.latent_dim))

    def get_action(self):
        """One dose per patient: uniform time in [0, t_max), uniform amount in [0, dose_max]."""
        dose_time = np.sort(
            np.stack([self.rng.choice(int(self.t_max), size=1, replace=False) for _ in range(self.n_sample)], axis=0)
        )
        dose_amount = self.rng.rand(self.n_sample) * self.dose_max
        return dose_time, dose_amount

    def generate_data(self, rtol: float = 1e-8, atol: float = 1e-10, max_steps: int = 4096,
                      backend: str = "torch"):
        """Draw the cohort and solve its ground truth; the solve's `Dopri5Stats` stay in `solve_stats`.

        `backend`: "torch", the lockstep DOPRI5 on the cohort's device; or
        "native", the C++ integrator on the host (`solve_stats` None), with
        JAX's budget of 100,000 steps a patient.
        """
        if backend not in ("torch", "native"):
            raise ValueError(f"backend must be 'torch' or 'native', not {backend!r}")
        init = self.get_initial_conditions()
        dose_time, dose_amount = self.get_action()
        self.dose_time = dose_time
        self.dose_amount = dose_amount

        ts = np.arange(0.0, self.t_max + self.step_size, self.step_size, dtype=np.float64)

        # Float64, the numerical regime of the reference's float64 LSODA; rtol 1e-8 is out of float32's reach.
        if backend == "native":
            from .. import native
            from ..config import ROCHE_PARAM_NAMES

            params13 = np.array([getattr(self.roche_config, n) for n in ROCHE_PARAM_NAMES], np.float64)
            latents = native.roche_dopri5_batch(init, dose_time.astype(np.float64), dose_amount, params13,
                                                self.ml_coef if self.ml_dim > 0 else None, ts, rtol=rtol, atol=atol,
                                                max_steps=100000)
            stats = None
        else:  # one lockstep solve of the whole cohort
            f64 = dict(dtype=torch.float64, device=self.device)
            ctx = DoseContext(times=torch.as_tensor(dose_time, **f64), amounts=torch.as_tensor(dose_amount, **f64))
            with torch.no_grad():
                latents, stats = odeint_dopri5(roche_field, torch.as_tensor(init, **f64),
                                               torch.as_tensor(ts, **f64), (self._ground_truth_params(), ctx),
                                               rtol=rtol, atol=atol, max_steps=max_steps)
            latents = latents.cpu().numpy()  # (T, B, D)
        assert np.all(np.isfinite(latents)), "ground-truth solve failed"

        # Linear observation head + Gaussian noise. The trailing output_coef
        # column multiplies a constant 1 (a bias term: the reference sizes it
        # by action_dim but feeds it ones).
        W = self.output_coef[:, : self.latent_dim]
        b = self.output_coef[:, self.latent_dim :].sum(axis=-1)
        output = latents @ W.T + b  # (T, B, obs)
        noise = self.rng.randn(*output.shape) * self.output_sigma
        measurements = output + noise

        # Discrete action array: the amount at the dose's grid index.
        is_dose = (ts[None, :, None] == dose_time[:, None, :]).any(-1)  # (B, T)
        actions = (is_dose * dose_amount[:, None]).T[..., None]  # (T, B, 1)

        self.latents = np.asarray(latents, np.float32)
        self.actions = np.asarray(actions, np.float32)

        # z-normalise the measurements over (T, B), per dimension.
        m = measurements
        m = (m - m.mean(axis=(0, 1))) / m.std(axis=(0, 1))
        self.measurements = np.asarray(m, np.float32)

        # Bernoulli missingness.
        selected = (self.rng.rand(*self.measurements.shape) > self.p_remove) * 1.0
        self.masks = np.asarray(np.ones_like(self.measurements) * selected, np.float32)

        assert self.measurements.shape == (self.time_dim, self.n_sample, self.obs_dim)
        assert self.actions.shape == (self.time_dim, self.n_sample, self.action_dim)
        assert self.latents.shape == (self.time_dim, self.n_sample, self.latent_dim)
        self.solve_stats = stats

    # --- persistence ------------------------------------------------------------

    def save(self, path: str):
        """Write the JAX package's cohort file: every attribute but the folds, the RNG, the device and the
        solve's step counts."""
        skip = ("data_train", "data_val", "data_test", "rng", "device", "solve_stats")
        state = {k: v for k, v in sorted(self.__dict__.items()) if k not in skip}
        save_pickle(path, {"class": "SyntheticCohort", "state": state})

    @classmethod
    def load(cls, path: str, device=None) -> "SyntheticCohort":
        payload = load_pickle(path)
        obj = cls.__new__(cls)
        obj.__dict__.update(payload["state"])
        obj.device = resolve_device(device)
        obj.data_train = obj.data_val = obj.data_test = None
        obj.split_sample()
        return obj

    def split_sample(self):
        tr, va = self.train_size, self.val_size
        full = {k: torch.as_tensor(np.asarray(getattr(self, k), np.float32), device=self.device) for k in self._KEYS}
        self.data_train = {k: v[:, :tr] for k, v in full.items()}
        self.data_val = {k: v[:, tr : tr + va] for k, v in full.items()}
        self.data_test = {k: v[:, tr + va :] for k, v in full.items()}

    def set_train_size(self, n_sample: int):
        train_sample_size = n_sample - self.val_size - self.test_size
        if train_sample_size <= 0:
            raise ValueError(
                f"sample={n_sample} leaves no training data (val={self.val_size} + test={self.test_size})"
            )
        self.train_size = train_sample_size
        self.n_sample = n_sample
        self.data_train = {k: v[:, :train_sample_size] for k, v in self.data_train.items()}

    def set_val_size(self, n_val: int):
        self.val_size = n_val
        self.data_val = {k: v[:, :n_val] for k, v in self.data_val.items()}

    def _fold(self, fold: str):
        if fold not in ("train", "val", "test"):
            raise ValueError(f"unknown fold {fold!r}")
        return {"train": self.data_train, "val": self.data_val, "test": self.data_test}[fold]

    def get_mini_batch(self, fold: str, batch_size: int, rng: np.random.RandomState):
        """`batch_size` patients of `fold` drawn without replacement by the numpy `rng`."""
        data = self._fold(fold)
        n = data["measurements"].shape[1]
        idx = torch.as_tensor(rng.choice(n, batch_size, replace=False), device=self.device)
        return {k: torch.index_select(v, 1, idx) for k, v in data.items()}

    def get_split(self, fold: str, batch_size: int, chunk: int = 0):
        data = self._fold(fold)
        lo, hi = chunk * batch_size, (chunk + 1) * batch_size
        return {k: v[:, lo:hi] for k, v in data.items()}


# The training cohort's settings (`make_train_cohort`), for a caller that builds it another way.
TRAIN_COHORT = dict(n_sample=1300, obs_dim=20, t_max=14, step_size=1, roche_config=RocheConfig(kel=1), output_sigma=0.2,
                    dose_max=10, latent_dim=6, sparsity=0.5, output_sparsity=0.5, p_remove=0.5, val_size=100,
                    test_size=200)


def make_train_cohort(seed: int = 666, n_sample: int = 1300, device=None, **overrides) -> SyntheticCohort:
    """The seed-666 training cohort (n=1300: 1000 train, 100 val, 200 test)."""
    kwargs = dict(TRAIN_COHORT, n_sample=n_sample, **overrides)
    dg = SyntheticCohort(rng=np.random.RandomState(seed), device=device, **kwargs)
    dg.generate_data()
    dg.split_sample()
    return dg


def make_test_cohort(seed: int = 666, device=None, **overrides) -> SyntheticCohort:
    """The seed-666 test cohort, n=2100 (100 val, 1000 test)."""
    overrides.setdefault("n_sample", 2100)
    overrides.setdefault("val_size", 100)
    overrides.setdefault("test_size", 1000)
    return make_train_cohort(seed=seed, device=device, **overrides)


def make_dim_cohort(dim: int, seed: int = 666, device=None, **overrides) -> SyntheticCohort:
    """The dim8 / dim12 cohorts (obs 40 / 80, latent 8 / 12)."""
    presets = {
        8: dict(obs_dim=40, latent_dim=8, output_sparsity=1 - 0.375),
        12: dict(obs_dim=80, latent_dim=12, output_sparsity=1 - 0.25),
    }
    kwargs = dict(presets[dim])
    kwargs.update(overrides)
    kwargs.setdefault("n_sample", 2100)
    kwargs.setdefault("val_size", 100)
    kwargs.setdefault("test_size", 1000)
    return make_train_cohort(seed=seed, device=device, **kwargs)


def add_noise(cohort: SyntheticCohort, noise_level: float, seed: int = 666) -> SyntheticCohort:
    """Noise variant of a test cohort: measurements += N(0, noise_level - 0.2)."""
    rng = np.random.RandomState(seed)
    noise = rng.randn(*cohort.measurements.shape).astype(np.float32) * (noise_level - 0.2)
    cohort.measurements = cohort.measurements + noise
    cohort.split_sample()
    return cohort
