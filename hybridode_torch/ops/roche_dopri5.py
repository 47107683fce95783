"""Per-row adaptive DOPRI5 of the hybrid Roche field without gradients: CUDA kernel and plain version.

The kernel (`csrc/roche_dopri5.cu`) replaces no TPU kernel. It runs, in one
launch, what the plain version runs as some 480 small kernels a trial step:
`odeint_dopri5(roche_field, y0, ts, (params, ctx), rtol, atol, max_steps,
per_row=True)` for one bolus dose a row, one thread a row, each row stopping
when it finishes. It is forward-only; the decoder takes it for decodes that
need no gradient (evaluation, the fused loop's validation), and the training
step keeps the plain solver. The kernel's header says what it computes and
how it rounds.

`roche_dopri5_per_row` launches the kernel on CUDA tensors and raises on
anything it cannot take; on CPU tensors it runs the plain version
`roche_dopri5_per_row_reference`. There is no fallback from one to the other.
Each launch adds one to `roche_dopri5_per_row.launches`. Inside
`dopri5.full_budget(tally)` the kernel adds the sum of its rows' trial steps
to both counters of the tally, on the device: it runs no trial step for a
finished row, so its live and its run trial steps are the same.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import ROCHE_PARAM_NAMES
from ..fields import DoseContext, roche_field
from ..solvers import dopri5
from ..solvers.dopri5 import Dopri5Stats, odeint_dopri5
from .roche_rk4 import _check


def roche_dopri5_per_row_reference(y0, times, amounts, expert_params, ml_w, ml_b, ts, rtol: float = 1e-7,
                                   atol: float = 1e-8, max_steps: int = 256):
    """Plain PyTorch version: `odeint_dopri5(roche_field, per_row=True)` on the same inputs -> (ys, stats)."""
    params = {"expert": {name: expert_params[name] for name in ROCHE_PARAM_NAMES}}
    if ml_w is not None:
        params["ml_net"] = [{"w": ml_w, "b": ml_b}]
    ctx = DoseContext(times=times[:, None], amounts=amounts)
    return odeint_dopri5(roche_field, y0, ts, (params, ctx), rtol=rtol, atol=atol, max_steps=max_steps,
                         per_row=True)


def roche_dopri5_per_row(y0, times, amounts, expert_params, ml_w, ml_b, ts, rtol: float = 1e-7, atol: float = 1e-8,
                         max_steps: int = 256):
    """Solve the hybrid Roche field from each row of `y0` with its own adaptive DOPRI5 controller.

    Args:
      y0: (B, D) initial latents, 4 <= D <= 8 (4 expert states + ml remainder).
      times: (B,) single-bolus dose times (NO_DOSE_TIME for no dose).
      amounts: (B,) dose amounts.
      expert_params: mapping of the 13 scalar rate constants (ROCHE_PARAM_NAMES).
      ml_w: (D, D-4) remainder weights, or None when D == 4.
      ml_b: (D-4,) remainder bias, or None when D == 4.
      ts: (T,) output grid, ascending.
      rtol, atol, max_steps: as `odeint_dopri5`; a row has ceil(max_steps / 64) * 64 trial steps.

    Returns (ys (T, B, D) float32, NaN at grid points a row never reached; Dopri5Stats with per-row
    `n_steps`, `n_accepted` (int32) and `success`).
    """
    if y0.device.type == "cpu":
        return roche_dopri5_per_row_reference(y0, times, amounts, expert_params, ml_w, ml_b, ts, rtol, atol,
                                              max_steps)
    if y0.device.type != "cuda":
        raise ValueError(f"roche_dopri5_per_row runs on CUDA or CPU tensors, not {y0.device}")
    params = torch.stack([expert_params[name].reshape(()) for name in ROCHE_PARAM_NAMES])
    B, D, T = _check(y0, times, amounts, params, ml_w, ml_b, ts)
    if int(max_steps) < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")
    tally = dopri5._TALLY
    if tally is not None and (tally.device != y0.device or tally.dtype != torch.int64 or tally.shape != (2,)):
        raise ValueError(f"the tally must be an int64 tensor of shape (2,) on {y0.device}")
    out = torch.empty((T, B, D), dtype=torch.float32, device=y0.device)
    n_trial, n_acc = (torch.empty(B, dtype=torch.int32, device=y0.device) for _ in range(2))
    success = torch.empty(B, dtype=torch.bool, device=y0.device)
    floor, rtol_floor = dopri5._noise_floor(torch.float32, rtol)
    err = _library().roche_dopri5_per_row_launch(
        y0.data_ptr(), times.data_ptr(), amounts.data_ptr(), params.data_ptr(),
        None if ml_w is None else ml_w.data_ptr(), None if ml_b is None else ml_b.data_ptr(), ts.data_ptr(),
        float(rtol), float(atol), floor, rtol_floor,  # ctypes rounds each to float32, as PyTorch does
        out.data_ptr(), n_trial.data_ptr(), n_acc.data_ptr(), success.data_ptr(),
        None if tally is None else tally.data_ptr(), B, D, T, trial_budget(max_steps),
        torch.cuda.current_stream(y0.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"roche_dopri5 kernel launch failed: cudaError_t {err}")
    roche_dopri5_per_row.launches += 1
    return out, Dopri5Stats(n_steps=n_trial, n_accepted=n_acc, success=success)


roche_dopri5_per_row.launches = 0


def trial_budget(max_steps: int) -> int:
    """The trial steps a row may take: the eager solver's chunks of 64, as many as `max_steps` asks for."""
    chunk = dopri5._CHUNK_SIZE
    return max(1, -(-int(max_steps) // chunk)) * chunk


def _library():
    from . import build

    lib = build.load("roche_dopri5")
    fn = lib.roche_dopri5_per_row_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
    return lib


def kernel_info(D: int) -> dict:
    """Registers and local (spill) bytes a thread of the built D-state kernel."""
    from . import build

    return build.kernel_info(_library(), "roche_dopri5_kernel_info", D)


def roche_dopri5_flops(n_trial: torch.Tensor, D: int) -> int:
    """FP32 operations of a solve whose rows took `n_trial` trial steps, counted from the formulas.

    A field evaluation as `roche_rk4_flops` counts it (4 + 26 + 2 D (D-4) + 2 (D-4)). A trial step: six field
    evaluations, the stage sums 48 D, the 5th-order solution 15 D, the error 14 D and its norm 14 D, the dense
    coefficients 20 D, the controller 10. A row's start: two evaluations and the initial step's 12 D + 20.
    Transcendentals count as one operation each, so this is a lower bound on the work.
    """
    ml = D - 4
    field = 4 + 26 + 2 * D * ml + 2 * ml
    trial = 6 * field + 111 * D + 10
    return int(n_trial.sum()) * trial + n_trial.numel() * (2 * field + 12 * D + 20)
