"""The run's surroundings: build caches inside the checkout, the device, the card's power limit, and the
guard that nothing of JAX or the JAX package was loaded."""

from __future__ import annotations

import os
import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "hybridode")  # top-level module names, compared whole


def prepare(root: str) -> str:
    """Point every build and kernel cache at fixed directories of the checkout; -> the run's scratch directory.

    `.torch_ext_build/` is where the program builds its CUDA kernels; Triton's
    and the CUDA driver's JIT caches go beside it. The host's math libraries
    get one thread each. Set before torch is imported.
    """
    cache = os.path.join(root, ".torch_ext_build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda_jit")
    os.environ["USE_FLAX"] = "0"
    for name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[name] = "1"  # one host thread: the host-bound cells spread less
    if root not in sys.path:
        sys.path.insert(0, root)  # the program's package sits at the root of the checkout
    work = os.path.join(root, ".bench_run")
    os.makedirs(work, exist_ok=True)
    return work


def jax_modules() -> list[str]:
    return sorted(name for name in list(sys.modules) if name.split(".")[0] in FORBIDDEN)


def device(chips: int, allow_cpu: bool = False):
    """The card this run measures on; raises SystemExit when CUDA is absent or has fewer cards than the cell asks
    for (`allow_cpu`, for the benchmark's CPU tests, runs on the CPU instead)."""
    import torch

    if allow_cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures the program on an NVIDIA GPU")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell asks for {chips} GPUs, {torch.cuda.device_count()} are visible")
    return torch.device("cuda", 0)


def card(dev) -> dict:
    """The card's name and power limit (nvidia-smi), the limit None where it cannot be read."""
    import torch

    if dev.type != "cuda":
        return {"kind": "cpu", "power_limit": None}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = None
    return {"kind": torch.cuda.get_device_name(dev), "power_limit": out}
