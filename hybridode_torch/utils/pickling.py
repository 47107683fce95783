"""Loading the JAX package's pickles without importing JAX or `hybridode`.

Cohort files pickle a `hybridode.config.RocheConfig` and the class object
`jax.numpy.float32`; a plain `pickle.load` would import both packages. The
unpickler here maps those two names onto the port's own classes and refuses
every other name from either package.
"""

from __future__ import annotations

import pickle

import numpy as np

from ..config import RocheConfig

_MAPPED = {
    ("hybridode.config", "RocheConfig"): RocheConfig,
    ("jax.numpy", "float32"): np.float32,
}
_FOREIGN = ("hybridode", "jax", "jaxlib")


class PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _MAPPED:
            return _MAPPED[(module, name)]
        if module.split(".")[0] in _FOREIGN:
            raise pickle.UnpicklingError(f"{module}.{name} has no counterpart in hybridode_torch")
        return super().find_class(module, name)


def load_pickle(path: str):
    with open(path, "rb") as f:
        return PortUnpickler(f).load()
