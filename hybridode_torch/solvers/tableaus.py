"""Butcher tableaus of the integrators.

The port's own copy of hybridode/solvers/tableaus.py: Dormand-Prince 5(4)
with its 4th-order dense output (Hairer, Norsett & Wanner, "Solving Ordinary
Differential Equations I"), and the fixed-step methods.
"""

from __future__ import annotations

import numpy as np

# --- Dormand-Prince 5(4) -----------------------------------------------------

DOPRI5_C = np.array([0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0])

DOPRI5_A = np.zeros((7, 7))
DOPRI5_A[1, 0] = 1 / 5
DOPRI5_A[2, :2] = [3 / 40, 9 / 40]
DOPRI5_A[3, :3] = [44 / 45, -56 / 15, 32 / 9]
DOPRI5_A[4, :4] = [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729]
DOPRI5_A[5, :5] = [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656]
DOPRI5_A[6, :6] = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]

# 5th-order solution weights (same as the last stage row: FSAL).
DOPRI5_B = DOPRI5_A[6].copy()

# Error weights: b5 - b4 (embedded 4th-order solution).
DOPRI5_E = np.array([71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200, 22 / 525, -1 / 40])

# Dense-output auxiliary weights (Hairer's D vector for DOPRI5).
DOPRI5_D = np.array(
    [
        -12715105075 / 11282082432,
        0.0,
        87487479700 / 32700410799,
        -10690763975 / 1880347072,
        701980252875 / 199316789632,
        -1453857185 / 822651844,
        69997945 / 29380423,
    ]
)

DOPRI5_ORDER = 5

# --- Classic fixed-step methods ----------------------------------------------

RK4_C = np.array([0.0, 0.5, 0.5, 1.0])
RK4_A = np.zeros((4, 4))
RK4_A[1, 0] = 0.5
RK4_A[2, 1] = 0.5
RK4_A[3, 2] = 1.0
RK4_B = np.array([1 / 6, 1 / 3, 1 / 3, 1 / 6])

MIDPOINT_C = np.array([0.0, 0.5])
MIDPOINT_A = np.zeros((2, 2))
MIDPOINT_A[1, 0] = 0.5
MIDPOINT_B = np.array([0.0, 1.0])

EULER_C = np.array([0.0])
EULER_A = np.zeros((1, 1))
EULER_B = np.array([1.0])

# Adams-Bashforth 4 history weights (the "explicit_adams" method).
AB4_COEFFS = np.array([55 / 24, -59 / 24, 37 / 24, -9 / 24])

FIXED_TABLEAUS = {
    "rk4": (RK4_C, RK4_A, RK4_B),
    "midpoint": (MIDPOINT_C, MIDPOINT_A, MIDPOINT_B),
    "euler": (EULER_C, EULER_A, EULER_B),
}
