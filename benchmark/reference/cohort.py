"""The cohorts as plain arrays, read from their files without the program and without JAX.

Each model family (`model.family`) reads its own cohort's files into arrays
(`arrays(cohort, root)`); the pickles are read here. A simulation cohort
file pickles `{"class": "SyntheticCohort", "state": {...}}` and names two
classes of the JAX package, `hybridode.config.RocheConfig` and
`jax.numpy.float32`; they are read as a plain record and as `numpy.float32`,
and any other name of those packages is refused.
"""

from __future__ import annotations

import pickle

import numpy as np


class _Record:
    """Stands in for a pickled dataclass: keeps its fields."""

    def __setstate__(self, state):
        self.__dict__.update(state)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("hybridode.config", "RocheConfig"):
            return _Record
        if (module, name) == ("jax.numpy", "float32"):
            return np.float32
        if module.split(".")[0] in ("hybridode", "hybridode_torch", "jax", "jaxlib", "flax"):
            raise pickle.UnpicklingError(f"{module}.{name} is not read by the benchmark")
        return super().find_class(module, name)


def read_pickle(path):
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def folds(arrays: dict, split: tuple, used: tuple) -> dict:
    """{key: (T, N, ...)} -> {fold: {key: array}}: consecutive folds of the sizes `split` (train, val, test), each
    cut to its first `used` patients."""
    out, lo = {}, 0
    for fold, n, keep in zip(("train", "val", "test"), split, used):
        out[fold] = {k: v[:, lo:lo + keep] for k, v in arrays.items()}
        lo += n
    return out


def load(cfg: dict, root: str) -> dict:
    """The cohort that a configuration names -> {fold: {key: float32 array (T, N, ...)}}, each fold cut to the
    configuration's first patients."""
    from . import model

    c = cfg["cohort"]
    arrays, split = model.family(cfg).arrays(c, root)
    return folds(arrays, split, (c["train"], c["val"], c["test"]))
