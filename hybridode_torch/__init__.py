"""hybridode_torch: the latent hybrid ODE framework in PyTorch and CUDA.

A port of the JAX package `hybridode` to PyTorch on an NVIDIA H100. It keeps
the JAX package's public layouts (linear weights `(in, out)` with
`y = x @ w`, LSTM gates in the order i, f, g, o) so that one converter
(`convert.py`) maps a JAX parameter tree onto the port name for name. The
port imports nothing of `jax` or `hybridode`.

Entry points run on CUDA unless the caller passes `device="cpu"`; without a
GPU and without that request they raise (`resolve_device`).
"""

from __future__ import annotations

import torch

# The port's counterpart of `jax_default_matmul_precision=highest`: TF32
# keeps ~3 decimal digits, and that noise collapses the adaptive solver's
# step size (the embedded error estimate reads it as truncation error).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks otherwise.

    Raises when CUDA is asked for (explicitly or by default) and absent; the
    port never falls back to the CPU on its own.
    """
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


__all__ = ["resolve_device", "__version__"]
