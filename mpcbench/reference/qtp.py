"""The quadruple-tank process as the tests of AutomationLabsModelPredictiveControl.jl
define it (test/modeler_implementation_test.jl:1817-1827; boxes :40-62): the
metre-scale four-tank benchmark's constants, the analytic Jacobian at an
operating point, and the zero-order-hold discretization, in float64."""

from __future__ import annotations

import numpy as np
import torch

S_TANK = 0.06  # tank cross-section, m^2
GAMMA = (0.3, 0.4)  # valve splits
G = 9.81
OUTLETS = (1.34e-4, 1.51e-4, 9.27e-5, 8.82e-5)  # outlet areas, m^2
X_BOX = ([0.2, 0.2, 0.2, 0.2], [1.36, 1.36, 1.30, 1.30])  # levels, m
U_BOX = ([0.0, 0.0], [4.0, 3.26])  # pump flows, m^3/h


def linear_system(cfg):
    """(A, B, x_box, u_box) of the discrete linearization at the
    configuration's ``x_op`` and ``sample_time``, float64 numpy."""
    a1, a2, a3, a4 = OUTLETS
    ga, gb = GAMMA
    x = np.asarray(cfg["x_op"], np.float64)
    d = G / np.sqrt(2.0 * G * x)  # d sqrt(2 g h) / dh
    Ac = np.zeros((4, 4))
    Ac[0, 0], Ac[0, 2] = -a1 / S_TANK * d[0], a3 / S_TANK * d[2]
    Ac[1, 1], Ac[1, 3] = -a2 / S_TANK * d[1], a4 / S_TANK * d[3]
    Ac[2, 2] = -a3 / S_TANK * d[2]
    Ac[3, 3] = -a4 / S_TANK * d[3]
    per_h = 1.0 / (S_TANK * 3600.0)  # flows in m^3/h
    Bc = np.zeros((4, 2))
    Bc[0, 0], Bc[1, 1] = ga * per_h, gb * per_h
    Bc[2, 1], Bc[3, 0] = (1 - gb) * per_h, (1 - ga) * per_h
    M = np.zeros((6, 6))
    M[:4, :4], M[:4, 4:] = Ac, Bc
    E = torch.linalg.matrix_exp(torch.from_numpy(M * float(cfg["sample_time"]))).numpy()
    return E[:4, :4], E[:4, 4:], X_BOX, U_BOX
