"""FLOPs and bytes of one launch of the port's per-row DOPRI5 kernel (`roche_dopri5`), by the conventions of
`benchmark/costs`.

A launch solves `rows` rows of the hybrid Roche field, each with its own controller, over a grid of `grid` points.
Its FLOPs are each row's trial steps (`dopri5_trial`: six new field evaluations, the stage sums, the 5th-order
solution, the error and its norm, the dense coefficients, the controller) plus each row's start (the first field
evaluation and Hairer's initial step with its one more evaluation). Its bytes are the inputs read once and the
outputs written once. At the forecast's shape (2,550 rows of a 15-point grid, ~120 trial steps a row) the FLOPs are
~10^8-10^9 and the bytes ~2 MB: a launch takes under a microsecond of HBM at 3.35 TB/s and some 10 us of FP32 at
67 TFLOP/s, so its roofline is the FP32 peak, and the bytes are not held against the card.
"""

from __future__ import annotations

from . import dopri5_trial, roche_field


def flops(rows: int, trials_per_row: float, latent: int, expert: int = 4) -> float:
    """FLOPs of one launch whose rows took `trials_per_row` trial steps on average."""
    field = roche_field(latent, expert)
    start = 2 * field + 12 * latent + 20
    return rows * (trials_per_row * dopri5_trial(latent, field) + start)


def nbytes(rows: int, latent: int, grid: int, expert: int = 4) -> int:
    """Bytes of one launch: y0, the dose times and amounts, the 13 constants, W and b, the grid, and the
    (grid, rows, latent) output with each row's trial steps, accepted steps and success, all read or written once."""
    ml = latent - expert
    return 4 * (rows * latent + 2 * rows + 13 + latent * ml + ml + grid + grid * rows * latent) + 9 * rows
