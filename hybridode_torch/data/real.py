"""Real-data (ICU cohort) loader and the synthetic stand-in writer.

Counterpart of `RealCohort` and `make_real_standin` in
hybridode/data/real.py:34-203. The loader reads the four pickles of a cohort
directory, `array_xt{type}.pkl` (measurements, (T, B, D)),
`array_xt_mask{type}.pkl`, `array_at{type}.pkl` (doses, (T, B, 1)) and
`array_x_constant.pkl` (statics, (B, S)), tiles the statics over time,
zero-fills the latents placeholder, and puts the train / val / test folds on
`device` as float32 tensors. It offers the fold API of `SyntheticCohort`, so
the training loop takes either.

`make_real_standin` writes deterministic arrays of the real cohort's shapes
(numpy only; the same arguments write the same arrays as the JAX package's).
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .. import resolve_device
from ..utils.pickling import load_pickle


def _load(path: str, name: str) -> np.ndarray:
    return np.asarray(load_pickle(os.path.join(path, name)), np.float32)


class RealCohort:
    """Fold-split view over the cohort arrays; `split_sample` puts the folds on `device`."""

    _KEYS = ("measurements", "actions", "latents", "masks", "statics")

    def __init__(self, data_path: str = "data/", data_type: str = "5", latent_dim: int = 10, val_size: int = 100,
                 test_size: int = 1000, device=None):
        self.device = resolve_device(device)
        self.measurements = _load(data_path, f"array_xt{data_type}.pkl")
        self.masks = _load(data_path, f"array_xt_mask{data_type}.pkl")
        self.actions = _load(data_path, f"array_at{data_type}.pkl")
        statics = _load(data_path, "array_x_constant.pkl")  # (B, S)

        t, b, d = self.masks.shape
        if self.measurements.shape != (t, b, d) or self.actions.shape[:2] != (t, b):
            raise ValueError(f"cohort arrays disagree: measurements {self.measurements.shape}, masks "
                             f"{self.masks.shape}, actions {self.actions.shape}")
        self.time_dim = t
        # The reference's convention: t_max IS the time dimension and the grid step is one hour.
        self.t_max = t
        self.step_size = 1.0
        self.n_sample = b
        self.obs_dim = d
        self.action_dim = self.actions.shape[2]
        self.latent_dim = int(latent_dim)
        self.static_dim = statics.shape[1]

        self.statics = np.ascontiguousarray(np.broadcast_to(statics[None], (t, b, self.static_dim)))
        self.latents = np.zeros((t, b, self.latent_dim), np.float32)

        self.val_size = int(val_size)
        self.test_size = int(test_size)
        self.train_size = int(b - val_size - test_size)
        self.rng = np.random.RandomState()
        self.data_train = self.data_val = self.data_test = None

    def split_sample(self):
        tr, va = self.train_size, self.val_size
        full = {k: torch.as_tensor(getattr(self, k), device=self.device) for k in self._KEYS}
        self.data_train = {k: v[:, :tr] for k, v in full.items()}
        self.data_val = {k: v[:, tr : tr + va] for k, v in full.items()}
        self.data_test = {k: v[:, tr + va :] for k, v in full.items()}

    def set_train_size(self, train_sample_size: int):
        """Train on the first N patients of the train fold; a request beyond the pool clamps to the pool."""
        if train_sample_size <= 0:
            raise ValueError(f"train_sample_size={train_sample_size} out of range")
        avail = self.n_sample - self.val_size - self.test_size
        if train_sample_size > avail:
            print(f"set_train_size: clamping {train_sample_size} -> {avail} (pool size)")
            train_sample_size = avail
        self.train_size = int(train_sample_size)
        self.data_train = {k: v[:, : self.train_size] for k, v in self.data_train.items()}

    def set_val_size(self, n_val: int):
        self.val_size = int(n_val)
        self.data_val = {k: v[:, :n_val] for k, v in self.data_val.items()}

    def _fold(self, fold: str):
        if fold not in ("train", "val", "test"):
            raise ValueError(f"unknown fold {fold!r}")
        return {"train": self.data_train, "val": self.data_val, "test": self.data_test}[fold]

    def get_mini_batch(self, fold: str, batch_size: int, rng: np.random.RandomState | None = None):
        """`batch_size` patients of `fold` drawn without replacement by `rng` (else the cohort's own)."""
        data = self._fold(fold)
        n = data["measurements"].shape[1]
        r = rng if rng is not None else self.rng
        idx = torch.as_tensor(r.choice(n, batch_size, replace=False), device=self.device)
        return {k: torch.index_select(v, 1, idx) for k, v in data.items()}

    def get_split(self, fold: str, batch_size: int, chunk: int = 0):
        data = self._fold(fold)
        lo, hi = chunk * batch_size, (chunk + 1) * batch_size
        return {k: v[:, lo:hi] for k, v in data.items()}


def make_real_standin(
    data_path: str,
    data_type: str = "5",
    n_sample: int = 2097,
    t_max: int = 97,
    obs_dim: int = 28,
    static_dim: int = 11,
    latent_dim: int = 6,
    mask_rate: float = 0.3,
    seed: int = 2021,
) -> None:
    """Write deterministic stand-in cohort arrays under `data_path`.

    Shapes default to the real cohort's ((97, 2097, 28) temporal, (2097, 11)
    statics). The dynamics are a stable nonlinear latent system driven by
    dose impulses and statics, observed through a random linear head.
    """
    rng = np.random.RandomState(seed)
    os.makedirs(data_path, exist_ok=True)

    # Dose schedule: 1-3 doses a patient, at hours in the first 70% of the stay, amounts uniform (0, 1].
    actions = np.zeros((t_max, n_sample, 1), np.float64)
    n_doses = rng.randint(1, 4, size=n_sample)
    for i in range(n_sample):
        hours = rng.choice(max(int(t_max * 0.7), 1), size=n_doses[i], replace=False)
        actions[hours, i, 0] += rng.rand(n_doses[i])

    # Statics: about half binary, half continuous (z-scored below).
    n_bin = static_dim // 2
    statics = np.concatenate(
        [rng.binomial(1, 0.4, (n_sample, n_bin)).astype(np.float64),
         rng.randn(n_sample, static_dim - n_bin)], axis=1,
    )

    # Latent dynamics: h' = tanh(W h + u b + s c) - decay * h, Euler dt=1.
    W = rng.randn(latent_dim, latent_dim) * (0.4 / np.sqrt(latent_dim))
    b_dose = rng.randn(latent_dim) * 0.8
    C = rng.randn(static_dim, latent_dim) * 0.15
    h = rng.randn(n_sample, latent_dim) * 0.5
    drive = statics @ C
    traj = np.empty((t_max, n_sample, latent_dim), np.float64)
    for t in range(t_max):
        traj[t] = h
        pre = h @ W.T + actions[t] * b_dose[None, :] + drive
        h = h + 0.5 * (np.tanh(pre) - 0.3 * h)

    # Observation head and noise, z-normalised per feature over (T, B).
    H = rng.randn(latent_dim, obs_dim) / np.sqrt(latent_dim)
    x = traj @ H + rng.randn(t_max, n_sample, obs_dim) * 0.15
    x = (x - x.mean(axis=(0, 1))) / np.maximum(x.std(axis=(0, 1)), 1e-8)

    masks = (rng.rand(t_max, n_sample, obs_dim) < mask_rate).astype(np.float32)

    out = {
        f"array_xt{data_type}.pkl": x.astype(np.float32),
        f"array_xt_mask{data_type}.pkl": masks,
        f"array_at{data_type}.pkl": actions.astype(np.float32),
        "array_x_constant.pkl": ((statics - statics.mean(0)) / np.maximum(statics.std(0), 1e-8)).astype(np.float32),
    }
    for name, arr in out.items():
        with open(os.path.join(data_path, name), "wb") as f:
            pickle.dump(arr, f)
