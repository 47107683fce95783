"""FLOPs and bytes of the measured work, counted from shapes: the same work whatever implements it.

Conventions, for every function here:

* A multiply-add is 2 FLOPs; an add, a multiply, a division, a comparison
  or a select is 1; exp, tanh, sigmoid, pow and sqrt count 1 each, so these
  counts are lower bounds of what a device executes.
* An adaptive DOPRI5 solve counts the trial steps that each row NEEDS at the
  configuration's rtol and atol (as the benchmark's reference counts them on
  the batches it recomputes), never the fixed budget that a captured graph
  runs; the dense coefficients are counted on every trial step.
* A backward pass counts twice its forward pass.
* Bytes are each input byte read once and each output byte written once,
  whatever a kernel reads again.
* Work on the host (numpy's bootstrap of the scores) is not counted: these
  FLOPs are held against the device's peak.

The counts of a model family sit in `costs/<kind>.py`, found by the
configuration's `kind`: `step_forward(cfg, trials)` and
`validation_forward(cfg, mix, trials)`, the forward FLOPs of one patient's
training loss and validation, and, for a family that forecasts,
`forecast_request(cfg, mix, trials)`. Each returns None where it needs the
trial steps and has none.
"""

from __future__ import annotations

import importlib
import math


def linear(n_in: int, n_out: int, bias: bool = True) -> int:
    return 2 * n_in * n_out + (n_out if bias else 0)


def lstm_step(n_in: int, hidden: int) -> int:
    """One LSTM step a row: the two gate products, three adds of 4H, four activations of H, c and h."""
    return 8 * hidden * (n_in + hidden) + 12 * hidden + 4 * hidden + 5 * hidden


def roche_field(latent: int, expert: int = 4) -> int:
    """One evaluation of the expert PK/PD field with its Linear+Tanh remainder, a row: the dose 4, the expert
    states 26, the remainder 2 D (D - 4) + 2 (D - 4) (the count of the roche_rk4 kernel's header)."""
    ml = latent - expert
    return 4 + 26 + 2 * latent * ml + 2 * ml


def dopri5_trial(latent: int, field: int) -> int:
    """One DOPRI5 trial step a row: six new stages (the first is the last step's), the stage sums 48 D, the 5th-order
    solution 15 D, the error 14 D and its norm 14 D, the dense coefficients 20 D, the controller 10."""
    return 6 * field + 111 * latent + 10


def rk4_step(latent: int, field: int) -> int:
    """One classic RK4 step a row: four evaluations, the stage updates 8 D and the weighted sum 9 D."""
    return 4 * field + 17 * latent


def roche_rk4_kernel(rows: int, latent: int, grid: int, n_sub: int) -> tuple[int, int]:
    """(FLOPs, bytes) of one roche_rk4 launch: `rows` trajectories of RK4 over `grid` points, `n_sub` steps an
    interval; bytes are y0, the dose times and amounts, the 13 constants, the remainder's weights and bias, the
    grid, and the (grid, rows, latent) output, all float32."""
    flops = rows * (grid - 1) * n_sub * rk4_step(latent, roche_field(latent))
    ml = latent - 4
    nbytes = 4 * (rows * latent + 2 * rows + 13 + latent * ml + ml + grid + grid * rows * latent)
    return flops, nbytes


def family(cfg: dict):
    """The counts of the configuration's kind."""
    return importlib.import_module(f"{__package__}.{cfg['kind']}")


def train_window(cfg: dict, mix: dict, iterations: int, validations: int, trials: float | None) -> float | None:
    """FLOPs of `iterations` training steps (forward, backward twice the forward, Adam 12 a parameter) and
    `validations` validations of the validation fold; None without the trial steps an adaptive solve needs."""
    from ..reference.model import layout

    fam = family(cfg)
    step, val = fam.step_forward(cfg, trials), fam.validation_forward(cfg, mix, trials)
    if step is None or val is None:
        return None
    leaves, _ = layout(cfg)
    n_params = sum(math.prod(shape) for shape, _ in leaves.values())
    return iterations * (3 * mix["batch_size"] * step + 12 * n_params) + validations * cfg["cohort"]["val"] * val


def forecast_request(cfg: dict, mix: dict, trials: float | None) -> float | None:
    """FLOPs of one forecast request (the family's count); None without the trial steps an adaptive solve needs."""
    return family(cfg).forecast_request(cfg, mix, trials)
