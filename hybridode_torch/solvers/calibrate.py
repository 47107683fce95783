"""Trial-step budget calibration for the adaptive integrator.

Counterpart of `calibrate_trial_budget` in hybridode/solvers/calibrate.py:33:
probe the trial-step demand once on a representative batch at a generous
budget, then round margin * max demand up to the solver's chunk of 64 steps.
A later batch that needs more leaves NaN in its solution (`stats.success`
False), which the training loop's finite-loss gate catches.

Per-patient arguments. JAX vmaps `args_batch` over axis 0, so each solve
sees one patient's slice. Here one `odeint_dopri5(per_row=True)` solves the
batch, and the field sees the whole `args`: a per-patient tensor must come
shaped to broadcast against the per-row time `(B, 1)` or the state `(B, D)`,
e.g. `ks[:, None]` for one rate a patient. A flat `(B,)` tensor would
broadcast against a `(B, 1)` state into `(B, B)`; the solver refuses a field
whose output is not the state's shape.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from .dopri5 import _CHUNK_SIZE, odeint_dopri5


def calibrate_trial_budget(
    field,
    y0_batch: torch.Tensor,
    ts,
    args_batch: Any = None,
    *,
    rtol: float = 1e-7,
    atol: float = 1e-8,
    margin: float = 1.25,
    probe_budget: int = 1024,
    per_sample: bool = True,
) -> int:
    """Measured trial-step budget for a batched solve, rounded to chunks.

    `y0_batch` is (B, D). With `per_sample` every row gets its own step
    control (the sim decoder's default); otherwise one lockstep solve probes
    the batch. Returns ceil(margin * max trial steps / 64) * 64. Raises
    RuntimeError if any probe row exhausted even the probe budget.
    """
    with torch.no_grad():
        _, stats = odeint_dopri5(field, y0_batch, ts, args_batch, rtol=rtol, atol=atol, max_steps=probe_budget,
                                 per_row=per_sample)
    if not bool(stats.success.all()):
        raise RuntimeError(f"calibration probe exhausted its own budget ({probe_budget}); "
                           "raise probe_budget or loosen tolerances")
    demand = int(stats.n_steps.max())
    return max(1, math.ceil(margin * demand / _CHUNK_SIZE)) * _CHUNK_SIZE
