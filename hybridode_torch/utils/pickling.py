"""The JAX package's pickles, read and written without importing JAX or `hybridode`.

Cohort files pickle a `hybridode.config.RocheConfig` and the class object
`jax.numpy.float32`; a plain `pickle.load` would import both packages. The
unpickler here maps those two names onto the port's own classes and refuses
every other name from either package. The pickler writes the port's
`RocheConfig` and `numpy.float32` under those two names, so that a plain
`pickle.load` in the JAX package reads the port's files as its own.
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
_WRITTEN = {obj: name for name, obj in _MAPPED.items()}


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


class PortPickler(pickle._Pickler):
    """Pickles the port's `RocheConfig` and `numpy.float32` classes under the JAX package's names.

    The pure-Python pickler, because the C one cannot name a class without
    importing its module. Protocol 4, as the JAX package's files are written.
    """

    def __init__(self, file):
        super().__init__(file, protocol=4)

    def save_global(self, obj, name=None):
        if obj not in _WRITTEN:
            return super().save_global(obj, name)
        module, qualname = _WRITTEN[obj]
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def save_pickle(path: str, obj):
    with open(path, "wb") as f:
        PortPickler(f).dump(obj)
