"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source `ops/csrc/<name>.cu` compiles on its own, at first use, into a
shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC -Xptxas -v

without `--use_fast_math` (expf, powf, tanhf and division stay accurate).
`roche_dopri5.cu` compiles once a state width D instead (4 <= D <= 12,
`WIDTHS`), with `-DROCHE_DOPRI5_DIM=D`, into a library of its own: a process
builds only the widths it launches, and the widths build in parallel.
`roche_real_ab4.cu` compiles once a (state width, hidden width) pair, D in
`AB4_DIMS` and H in `AB4_HIDDEN`, with `-DROCHE_REAL_AB4_DIM=D
-DROCHE_REAL_AB4_HIDDEN=H`, when a process first launches that pair. A
library goes into `.torch_ext_build/` at the root of the checkout, named by a
hash of the source, of every header it includes from `csrc/` (`#include
"..."`, followed into the headers' own includes) and of the flags, so a
changed source or header is rebuilt and an unchanged one is loaded as it
is. `build_all` starts one nvcc per library, all together, and waits for
them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.normpath(os.path.join(CSRC, os.pardir, os.pardir, os.pardir, ".torch_ext_build"))
# The macros a source compiled once a width sets to it: the one state width of a roche_dopri5.cu library, the state
# and hidden widths of a roche_real_ab4.cu library.
WIDTH_MACROS = {"roche_dopri5": ("ROCHE_DOPRI5_DIM",),
                "roche_real_ab4": ("ROCHE_REAL_AB4_DIM", "ROCHE_REAL_AB4_HIDDEN")}
WIDTHS = tuple(range(4, 13))  # the state widths the Roche kernels are built for: 4 expert states + 0-8 learned
# The widths the real track's explicit-Adams kernels take, a library a (D, H) pair: 4 expert states and a GRU of up to
# 28 (one state a lane of the row's warp, the GRU's weights' partial gradients in registers), and up to two of the
# MLPs' hidden units a lane.
AB4_DIMS, AB4_HIDDEN = range(4, 33), range(1, 65)
# The libraries of one width each or of none: (source, width or None). roche_real_ab4's pairs are built on first use.
TARGETS = (("roche_rk4", None), *(("roche_dopri5", D) for D in WIDTHS))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


@dataclass(frozen=True)
class Built:
    name: str
    path: str
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (ptxas registers, shared memory and spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: str, seen: list[str]) -> list[str]:
    """`path` and, depth first, every file it includes with quotes from its own directory, each once."""
    if path in seen:
        return seen
    seen.append(path)
    with open(path, "rb") as f:
        for name in _INCLUDE.findall(f.read()):
            _sources(os.path.join(os.path.dirname(path), name.decode()), seen)
    return seen


def _widths(dim) -> tuple:
    return () if dim is None else tuple(dim) if isinstance(dim, tuple) else (int(dim),)


def _label(name: str, dim) -> str:
    return name + "".join(f"_{k}{v}" for k, v in zip("dh", _widths(dim)))


def _target(name: str, dim=None) -> tuple[str, str, tuple]:
    src = os.path.join(CSRC, f"{name}.cu")
    flags = NVCC_FLAGS + tuple(f"-D{m}={int(v)}" for m, v in zip(WIDTH_MACROS.get(name, ()), _widths(dim)))
    digest = hashlib.sha256()
    for path in _sources(src, []):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(flags).encode())
    return src, os.path.join(BUILD_DIR, f"{_label(name, dim)}-{digest.hexdigest()[:16]}.so"), flags


def build_all(targets=TARGETS) -> dict[str, Built]:
    """Compile every library of `targets`, (source, width or None) pairs, that is not built yet, in parallel; raise
    if any fails. Keyed by the source's name, with `_d<width>` after it for a width (`_d<D>_h<H>` for a pair)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    started, done = {}, {}
    t0 = time.perf_counter()
    for name, dim in targets:
        src, lib, flags = _target(name, dim)
        label = _label(name, dim)
        if os.path.exists(lib):
            done[label] = Built(label, lib, 0.0, "")
            continue
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *flags, "-o", tmp, src]
        started[label] = (lib, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                     text=True))
    failures = []
    for label, (lib, tmp, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{label}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent builder never loads a half-written library
        done[label] = Built(label, lib, time.perf_counter() - t0, log)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return done


@functools.cache
def load(name: str, dim=None) -> ctypes.CDLL:
    """The built library of one kernel (of one state width `dim` for roche_dopri5, a (D, H) for roche_real_ab4),
    compiled first if need be."""
    return ctypes.CDLL(build_all(((name, dim),))[_label(name, dim)].path)


def c_function(lib: ctypes.CDLL, symbol: str, argtypes: list):
    """The C function `symbol` of a loaded library, taking `argtypes` and returning a cudaError_t: a call raises
    RuntimeError where that is not cudaSuccess (0)."""
    fn = getattr(lib, symbol)
    fn.restype, fn.argtypes, fn.errcheck = ctypes.c_int, argtypes, _raise_on_error
    return fn


def _raise_on_error(err, fn, args):
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: cudaError_t {err}")
    return err


def kernel_info(lib: ctypes.CDLL, symbol: str, *args: int) -> dict:
    """Registers and local (spill) bytes a thread of a kernel of a loaded library, from its C function
    `symbol(int args..., int *registers, int *local_bytes) -> cudaError_t`."""
    fn = c_function(lib, symbol, [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)] * 2)
    vals = [ctypes.c_int(0) for _ in range(2)]
    fn(*(int(a) for a in args), *(ctypes.byref(v) for v in vals))
    return dict(zip(("registers", "local_bytes"), (v.value for v in vals)))
