"""Synthetic PK/PD cohorts: loading and fold splits.

Counterpart of `SyntheticCohort.load`, `split_sample`, `get_mini_batch`,
`get_split`, `set_train_size` and `set_val_size` in hybridode/data/synthetic.py:192-257. Generation stays in
the JAX package; the port reads the cohort files it writes.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..utils.pickling import load_pickle

EXPERT_DIM = 4


class SyntheticCohort:
    """Holds the (T, B, D) cohort arrays and float32 fold tensors on `device`."""

    _KEYS = ("measurements", "actions", "latents", "masks")

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
