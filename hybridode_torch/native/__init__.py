"""The native C++ library: a float64 DOPRI5 of the Roche field and NNLS (counterpart of hybridode/native/).

`native.cpp` is the port's own copy of the JAX package's source. It is
built with g++ at first use,

    g++ -O3 -march=native -shared -fPIC native.cpp

into `.torch_ext_build/` at the root of the checkout (where `ops/build.py`
puts the CUDA kernels), named by a hash of the source and the flags, and
loaded with ctypes. Nothing is built into the package directory.
`available()` says whether the library builds and loads; the two functions
raise, with the compiler's output, when it does not. Their contracts are the
JAX package's (hybridode/native/__init__.py:70-119).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

from ..ops.build import BUILD_DIR

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native.cpp")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_P = ctypes.POINTER(ctypes.c_double)


def _target() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"native-{digest}.so")


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, compiled first if need be; raises RuntimeError with g++'s output when that fails."""
    path = _target()
    if not os.path.exists(path):
        compiler = shutil.which("g++")
        if compiler is None:
            raise RuntimeError("the native library needs g++, which is not on PATH")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        out = subprocess.run([compiler, *FLAGS, SRC, "-o", tmp], capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"building the native library failed (g++ exited {out.returncode}):\n"
                               f"{out.stdout}{out.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent build never loads a half-written library
    lib = ctypes.CDLL(path)
    lib.ho_roche_dopri5_batch.restype = ctypes.c_int
    lib.ho_roche_dopri5_batch.argtypes = [
        _P, ctypes.c_int, ctypes.c_int,
        _P, ctypes.c_int,
        _P, _P,
        _P, ctypes.c_int,
        _P, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_int,
        _P,
    ]
    lib.ho_nnls.restype = ctypes.c_int
    lib.ho_nnls.argtypes = [_P, _P, ctypes.c_int, ctypes.c_int, _P, _P]
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _lib()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_P)


def roche_dopri5_batch(y0, dose_times, dose_amounts, params13, ml_coef, ts, rtol=1e-8, atol=1e-10,
                       max_steps=100000):
    """The cohort's ground truth in C++ (float64, one DOPRI5 a patient) -> (T, B, D).

    `y0` (B, D), `dose_times` (B, n_dose), `dose_amounts` (B,), `params13`
    the 13 Roche constants in `config.ROCHE_PARAM_NAMES`' order, `ml_coef`
    (D, D - 4) (None when D = 4), `ts` (T,). Raises when a patient's solve
    fails.
    """
    lib = _lib()
    y0 = np.ascontiguousarray(y0, np.float64)
    dose_times = np.ascontiguousarray(dose_times, np.float64)
    dose_amounts = np.ascontiguousarray(dose_amounts, np.float64)
    params13 = np.ascontiguousarray(params13, np.float64)
    ts = np.ascontiguousarray(ts, np.float64)
    B, D = y0.shape
    n_dose = dose_times.shape[1]
    ml_dim = D - 4
    if dose_times.shape[0] != B or dose_amounts.shape != (B,) or params13.shape != (13,):
        raise ValueError(f"shapes y0 {y0.shape}, dose_times {dose_times.shape}, dose_amounts {dose_amounts.shape}, "
                         f"params13 {params13.shape} do not fit")
    if ml_dim > 0:
        ml = np.ascontiguousarray(ml_coef, np.float64)
        if ml.shape != (D, ml_dim):
            raise ValueError(f"ml_coef has shape {ml.shape}, expected {(D, ml_dim)}")
    else:
        ml = np.zeros((D, 0), np.float64)
    T = len(ts)
    out = np.empty((T, B, D), np.float64)
    failures = lib.ho_roche_dopri5_batch(
        _ptr(y0), B, D, _ptr(dose_times), n_dose, _ptr(dose_amounts),
        _ptr(params13), _ptr(ml), ml_dim, _ptr(ts), T,
        ctypes.c_double(rtol), ctypes.c_double(atol), max_steps, _ptr(out))
    if failures:
        raise RuntimeError(f"native cohort solve failed for {failures} patients")
    return out


def nnls(A, b):
    """Lawson-Hanson NNLS in C++ -> (x, residual norm): scipy.optimize.nnls's contract."""
    lib = _lib()
    A = np.ascontiguousarray(A, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    m, n = A.shape
    if b.shape != (m,):
        raise ValueError(f"b has shape {b.shape}, expected {(m,)}")
    x = np.empty(n, np.float64)
    rnorm = ctypes.c_double(0.0)
    lib.ho_nnls(_ptr(A), _ptr(b), m, n, _ptr(x), ctypes.byref(rnorm))
    return x, float(rnorm.value)
