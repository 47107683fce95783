"""Butcher tableaus of the fixed-step integrators.

The port's own copy of the fixed-step part of hybridode/solvers/tableaus.py;
the Dormand-Prince tableau comes with the adaptive solver.
"""

from __future__ import annotations

import numpy as np

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
