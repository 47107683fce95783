"""Per-row adaptive DOPRI5 of the hybrid Roche field, with and without gradients: CUDA kernels and plain version.

The kernels (`csrc/roche_dopri5.cu`) replace no TPU kernel. The solve runs,
in one launch, what the plain version runs as some 480 small kernels a trial
step: `odeint_dopri5(roche_field, y0, ts, (params, ctx), rtol, atol,
max_steps, per_row=True)` for one bolus dose a row, one thread a row, each
row stopping when it finishes. `contract.roche_kernel` routes to it the
decodes that need no gradient (evaluation, the fused loop's validation).
The kernel's header says what it computes and how it rounds.

`roche_dopri5_per_row` launches it on CUDA tensors and raises on anything it
cannot take; on CPU tensors it runs the plain version
`roche_dopri5_per_row_reference`. There is no fallback from one to the other.
Each launch adds one to `roche_dopri5_per_row.launches`.

`roche_dopri5_per_row_grad` is the same solve with gradients for y0, ml_w
and ml_b, one `torch.autograd.Function` (the training step's decode): its
forward is the solve that also records each row's accepted steps (t, h and
the state at the step's start), one launch whose outputs are the solve's bit
for bit; its backward one launch that replays each row's recorded steps in
reverse, each recomputed from its start as `dopri5.replay_step` recomputes
it, and sums the rows' partial ml_w and ml_b gradients in a fixed order
(no float atomics: two backward passes agree bit for bit). The gradients are
the plain solver's, discretize-then-optimize through the accepted steps:
step sizes, the error norm and the controller carry none. One difference:
the plain solver's backward also runs through every rejected trial, whose
stages, where they overflow, put 0 * inf = NaN into the gradient through the
select; the kernel replays no rejected trial. The 13 expert constants get no
gradient (`contract.roche_kernel` refuses the route where one needs it). On
CPU tensors it runs the plain solver with autograd. Each forward launch adds
one to `roche_dopri5_per_row_grad.launches`. The grid must ascend.

Inside `dopri5.full_budget(tally)` either solve adds the sum of its rows' trial steps
to both counters of the tally, on the device: it runs no trial step for a
finished row, so its live and its run trial steps are the same. Each launch
outside a CUDA graph's capture adds its rows' trial and accepted steps, on
the device, and its rows, on the host, to the process-wide counter `EAGER`,
which `EAGER.read()` reads.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import ROCHE_PARAM_NAMES
from ..fields import roche_field
from ..solvers import dopri5
from ..solvers.dopri5 import Dopri5Stats, odeint_dopri5
from ..utils.logging import DeviceCounter
from . import build
from .contract import check, constants, field_args

# The eager launches' sums: trial and accepted steps on the device, launches and rows on the host. `EAGER.read()`
# reads each device once: call it outside a timed stretch.
EAGER = DeviceCounter(("trial_steps", "accepted_steps"), ("launches", "rows"))
# The argument types of the two launch functions of a library (one a width, `build.WIDTHS`).
_SOLVE_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_float] * 4 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
               + [ctypes.c_void_p])
_BACKWARD_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def roche_dopri5_per_row_reference(y0, times, amounts, expert_params, ml_w, ml_b, ts, rtol: float = 1e-7,
                                   atol: float = 1e-8, max_steps: int = 256):
    """Plain PyTorch version: `odeint_dopri5(roche_field, per_row=True)` on the same inputs -> (ys, stats)."""
    return odeint_dopri5(roche_field, y0, ts, field_args(times, amounts, expert_params, ml_w, ml_b), rtol=rtol,
                         atol=atol, max_steps=max_steps, per_row=True)


def roche_dopri5_per_row(y0, times, amounts, expert_params, ml_w, ml_b, ts, rtol: float = 1e-7, atol: float = 1e-8,
                         max_steps: int = 256):
    """Solve the hybrid Roche field from each row of `y0` with its own adaptive DOPRI5 controller.

    Args:
      y0: (B, D) initial latents, 4 <= D <= 12, `build.WIDTHS` (4 expert states + ml remainder).
      times: (B,) single-bolus dose times (NO_DOSE_TIME for no dose).
      amounts: (B,) dose amounts.
      expert_params: mapping of the 13 scalar rate constants (ROCHE_PARAM_NAMES).
      ml_w: (D, D-4) remainder weights, or None when D == 4.
      ml_b: (D-4,) remainder bias, or None when D == 4.
      ts: (T,) output grid, ascending.
      rtol, atol, max_steps: as `odeint_dopri5`; a row has `dopri5.trial_budget(max_steps)` trial steps.

    Returns (ys (T, B, D) float32, NaN at grid points a row never reached; Dopri5Stats with per-row
    `n_steps`, `n_accepted` (int32) and `success`).
    """
    if y0.device.type == "cpu":
        return roche_dopri5_per_row_reference(y0, times, amounts, expert_params, ml_w, ml_b, ts, rtol, atol,
                                              max_steps)
    out, stats, _ = _solve(y0, times, amounts, expert_params, ml_w, ml_b, ts, rtol, atol, max_steps, record=False)
    roche_dopri5_per_row.launches += 1
    return out, stats


roche_dopri5_per_row.launches = 0


def roche_dopri5_per_row_grad(y0, times, amounts, expert_params, ml_w, ml_b, ts, rtol: float = 1e-7,
                              atol: float = 1e-8, max_steps: int = 256):
    """`roche_dopri5_per_row` with gradients for `y0`, `ml_w` and `ml_b`: the same arguments and results.

    On CUDA one recording launch forward and one launch backward (the module docstring); `expert_params` must
    not require grad. On CPU tensors the plain solver with autograd.
    """
    if y0.device.type == "cpu":
        return roche_dopri5_per_row_reference(y0, times, amounts, expert_params, ml_w, ml_b, ts, rtol, atol,
                                              max_steps)
    if any(expert_params[name].requires_grad for name in ROCHE_PARAM_NAMES):
        raise ValueError("roche_dopri5_per_row_grad gives no gradient for the expert constants")
    out, n_trial, n_acc, success = _Dopri5Grad.apply(y0, ml_w, ml_b, times, amounts, expert_params, ts, rtol, atol,
                                                     max_steps)
    return out, Dopri5Stats(n_steps=n_trial, n_accepted=n_acc, success=success)


roche_dopri5_per_row_grad.launches = 0


class _Dopri5Grad(torch.autograd.Function):
    """The recording solve forward, the replay of its accepted steps backward."""

    @staticmethod
    def forward(ctx, y0, ml_w, ml_b, times, amounts, expert_params, ts, rtol, atol, max_steps):
        out, st, record = recorded_solve(y0, times, amounts, expert_params, ml_w, ml_b, ts, rtol, atol, max_steps)
        roche_dopri5_per_row_grad.launches += 1
        ctx.expert_params = expert_params
        ctx.save_for_backward(times, amounts, ml_w, ml_b, ts, record, st.n_accepted)
        ctx.mark_non_differentiable(st.n_steps, st.n_accepted, st.success)
        return out, st.n_steps, st.n_accepted, st.success

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out, *_):
        times, amounts, ml_w, ml_b, ts, record, n_accepted = ctx.saved_tensors
        grads = backward(times, amounts, ctx.expert_params, ml_w, ml_b, ts, record, n_accepted, g_out)
        return *(g if needed else None for g, needed in zip(grads, ctx.needs_input_grad)), *(None,) * 7


def recorded_solve(y0, times, amounts, expert_params, ml_w, ml_b, ts, rtol: float = 1e-7, atol: float = 1e-8,
                   max_steps: int = 256):
    """The recording launch alone, on CUDA tensors -> (ys, Dopri5Stats, record): `record[b, n]` is row b's n-th
    accepted step (t, h, then the state at its start), for n < `n_accepted[b]`; the entries past it are not
    written. The outputs are `roche_dopri5_per_row`'s bit for bit."""
    return _solve(y0, times, amounts, expert_params, ml_w, ml_b, ts, rtol, atol, max_steps, record=True)


def backward(times, amounts, expert_params, ml_w, ml_b, ts, record, n_accepted, g_out):
    """The backward launch: the gradients (dy0, d_ml_w, d_ml_b) of a recorded solve (`recorded_solve`) whose output
    has gradient `g_out` (T, B, D). d_ml_w and d_ml_b are None when D == 4. The rows' partial gradients are summed
    in PyTorch's fixed order of a reduction."""
    B, budget, width = record.shape
    D, T = width - 2, ts.shape[0]
    g_out = g_out.to(torch.float32).contiguous()
    if g_out.shape != (T, B, D):
        raise ValueError(f"the output's gradient has shape {tuple(g_out.shape)}, not {(T, B, D)}")
    ml = D - 4
    dy0 = torch.empty((B, D), dtype=torch.float32, device=record.device)
    dparams = torch.empty((B, D * ml + ml), dtype=torch.float32, device=record.device) if ml else None
    params = constants(expert_params, record)
    launch = build.c_function(build.load("roche_dopri5", D), "roche_dopri5_backward_launch", _BACKWARD_ARGS)
    launch(
        times.data_ptr(), amounts.data_ptr(), params.data_ptr(), _ptr(ml_w), _ptr(ml_b), ts.data_ptr(),
        record.data_ptr(), n_accepted.data_ptr(), g_out.data_ptr(), dy0.data_ptr(), _ptr(dparams), B, D, T, budget,
        _stream(record.device),
    )
    if not ml:
        return dy0, None, None
    total = dparams.sum(dim=0)
    return dy0, total[: D * ml].reshape(D, ml), total[D * ml :]


def _ptr(x):
    return None if x is None else x.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _solve(y0, times, amounts, expert_params, ml_w, ml_b, ts, rtol, atol, max_steps, record: bool):
    """One launch of the solve, recording or not -> (out, Dopri5Stats, record or None)."""
    params = constants(expert_params, y0)
    B, D, T = check(y0, times, amounts, params, ml_w, ml_b, ts)
    if int(max_steps) < 1:
        raise ValueError(f"max_steps must be >= 1, got {max_steps}")
    tally = dopri5.open_tally()
    if tally is not None and (tally.device != y0.device or tally.dtype != torch.int64 or tally.shape != (2,)):
        raise ValueError(f"the tally must be an int64 tensor of shape (2,) on {y0.device}")
    budget = dopri5.trial_budget(max_steps)
    out = torch.empty((T, B, D), dtype=torch.float32, device=y0.device)
    n_trial, n_acc = (torch.empty(B, dtype=torch.int32, device=y0.device) for _ in range(2))
    success = torch.empty(B, dtype=torch.bool, device=y0.device)
    steps = torch.empty((B, budget, D + 2), dtype=torch.float32, device=y0.device) if record else None
    floor, rtol_floor = dopri5.noise_floor(torch.float32, rtol)
    eager = not torch.cuda.is_current_stream_capturing()
    counts = EAGER.tensor(y0.device) if eager else None
    launch = build.c_function(build.load("roche_dopri5", D), "roche_dopri5_per_row_launch", _SOLVE_ARGS)
    launch(
        y0.data_ptr(), times.data_ptr(), amounts.data_ptr(), params.data_ptr(), _ptr(ml_w), _ptr(ml_b),
        ts.data_ptr(), float(rtol), float(atol), floor, rtol_floor,  # ctypes rounds each to float32, as PyTorch does
        out.data_ptr(), n_trial.data_ptr(), n_acc.data_ptr(), success.data_ptr(), _ptr(steps), _ptr(tally),
        _ptr(counts), B, D, T, budget, _stream(y0.device),
    )
    if eager:
        EAGER.add(launches=1, rows=B)
    return out, Dopri5Stats(n_steps=n_trial, n_accepted=n_acc, success=success), steps


KINDS = ("solve", "record", "backward")  # the kernels of a library, in the order of the C side's `Kind`


def kernel_info(D: int, kind: str = "solve") -> dict:
    """Registers and local (spill) bytes a thread of the built D-state kernel of `kind` (`KINDS`): the solve, the
    recording solve or the backward."""
    return build.kernel_info(build.load("roche_dopri5", D), "roche_dopri5_kernel_info", KINDS.index(kind), D)


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


def roche_dopri5_backward_flops(n_accepted: torch.Tensor, D: int, T: int) -> int:
    """FP32 operations of the backward launch over rows that accepted `n_accepted` steps, counted as
    `roche_dopri5_flops` counts, a lower bound.

    An accepted step: seven field evaluations (the step recomputed from its start) and seven vector-Jacobian
    products of the field (the expert terms 45, the remainder (D-4) (4 D + 4)); the stage states twice 48 D, the
    stages' gradients into y and the earlier stages 55 D, the step's sum and dense coefficients into the stages 35 D.
    A row: the dense output's gradient at each grid point, 12 D + 8.
    """
    ml = D - 4
    field = 4 + 26 + 2 * D * ml + 2 * ml
    vjp = 45 + ml * (4 * D + 4)
    step = 7 * (field + vjp) + 186 * D
    return int(n_accepted.sum()) * step + n_accepted.numel() * T * (12 * D + 8)
