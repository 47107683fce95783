"""Fixed-step RK4 trajectory of the hybrid Roche field: CUDA kernel and plain version.

Port of the Pallas TPU kernel `roche_rk4_trajectory`
(hybridode/ops/pallas/roche_kernel.py:114, pl.pallas_call at :151). The
kernel (`csrc/roche_rk4.cu`) integrates the expert-PK/PD ++ tanh-remainder
field with `n_substeps` RK4 steps per grid interval and writes only the T
grid states. It is forward-only: evaluation's posterior decodes need no
gradient. One thread integrates one trajectory; Hill exponents of exactly 2
(the repo's) are taken as x * x, not powf, and the dose term is computed
once per step. What bounds it is one warp's serial stream through the field
evaluations, so its time is nearly flat in B; the kernel's header says more,
and `roche_rk4_study.py` at the root of the checkout measures it.

`roche_rk4_trajectory` launches the kernel on CUDA tensors and raises on
anything it cannot take; on CPU tensors it runs the plain version
`roche_rk4_trajectory_reference` (an RK4 loop over the port's `roche_field`).
There is no fallback from one to the other. Each launch adds one to
`roche_rk4_trajectory.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields import roche_field
from ..solvers import odeint_fixed
from . import build
from .contract import check, constants, field_args

_LAUNCH_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]  # roche_rk4_trajectory_launch's


def roche_rk4_trajectory_reference(y0, times, amounts, expert_params, ml_w, ml_b, ts, n_substeps: int = 1):
    """Plain PyTorch version: `odeint_fixed(roche_field, method="rk4")` on the same inputs."""
    return odeint_fixed(roche_field, y0, ts, field_args(times, amounts, expert_params, ml_w, ml_b), method="rk4",
                        n_substeps=n_substeps)


def roche_rk4_trajectory(y0, times, amounts, expert_params, ml_w, ml_b, ts, n_substeps: int = 1):
    """Integrate the hybrid Roche field with fused RK4.

    Args:
      y0: (B, D) initial latents, 4 <= D <= 12, `build.WIDTHS` (4 expert states + ml remainder).
      times: (B,) single-bolus dose times (NO_DOSE_TIME for no dose).
      amounts: (B,) dose amounts.
      expert_params: mapping of the 13 scalar rate constants (ROCHE_PARAM_NAMES).
      ml_w: (D, D-4) remainder weights, or None when D == 4.
      ml_b: (D-4,) remainder bias, or None when D == 4.
      ts: (T,) output grid.
      n_substeps: RK4 steps per grid interval.

    Returns (T, B, D) float32.
    """
    if y0.device.type == "cpu":
        return roche_rk4_trajectory_reference(y0, times, amounts, expert_params, ml_w, ml_b, ts, n_substeps)
    params = constants(expert_params, y0)
    B, D, T = check(y0, times, amounts, params, ml_w, ml_b, ts)
    if int(n_substeps) < 1:
        raise ValueError(f"n_substeps must be >= 1, got {n_substeps}")
    out = torch.empty((T, B, D), dtype=torch.float32, device=y0.device)
    launch = build.c_function(build.load("roche_rk4"), "roche_rk4_trajectory_launch", _LAUNCH_ARGS)
    launch(
        y0.data_ptr(), times.data_ptr(), amounts.data_ptr(), params.data_ptr(),
        None if ml_w is None else ml_w.data_ptr(), None if ml_b is None else ml_b.data_ptr(),
        ts.data_ptr(), out.data_ptr(), B, D, T, int(n_substeps),
        torch.cuda.current_stream(y0.device).cuda_stream,
    )
    roche_rk4_trajectory.launches += 1
    return out


roche_rk4_trajectory.launches = 0


def kernel_info(D: int) -> dict:
    """Registers and local (spill) bytes a thread of the built D-state kernel."""
    return build.kernel_info(build.load("roche_rk4"), "roche_rk4_kernel_info", D)


def roche_rk4_flops(B: int, D: int, T: int, n_substeps: int) -> int:
    """FP32 operations of the solve, counted from the field's formula.

    Per field evaluation: dose 4 (sub, 2 mul, exp), expert states 26
    (2 powf, 1 division, 23 mul/add), remainder 2*D*(D-4) multiply-adds plus
    (D-4) bias adds and (D-4) tanh. Per RK4 step: 4 evaluations plus the
    stage updates (3D + 3D + 2D) and the weighted sum (9D). Transcendentals
    count as one operation each, so this is a lower bound on the work.
    """
    ml = D - 4
    field = 4 + 26 + 2 * D * ml + 2 * ml
    step = 4 * field + 8 * D + 9 * D
    return B * (T - 1) * n_substeps * step
