"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Importing this package builds nothing: a kernel is compiled at its first
launch on a CUDA tensor (see `build.py`).
"""

from .roche_dopri5 import roche_dopri5_per_row, roche_dopri5_per_row_reference
from .roche_rk4 import roche_rk4_trajectory, roche_rk4_trajectory_reference

__all__ = ["roche_dopri5_per_row", "roche_dopri5_per_row_reference", "roche_rk4_trajectory",
           "roche_rk4_trajectory_reference"]
