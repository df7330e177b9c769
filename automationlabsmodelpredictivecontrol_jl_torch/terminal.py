"""Terminal-ingredient synthesis (terminal cost + terminal set).

- terminal cost P: the DARE solution (scipy, f64) at the system's
  linearization around the last reference point;
- kind "equality": e_x_N == 0; kind "contractive": a Euclidean-ball block
  enforced downstream by projection; kind "none": cost only.

Kind "neighborhood" (the LQR-invariant set ``invariant_terminal_set``) is
not ported yet (ROADMAP Queue 1, "Neighborhood terminal sets").
"""

from __future__ import annotations

from typing import Any

import numpy as np
import scipy.linalg as sla

from .systems import linearize
from .types import References, TerminalIngredient, Weights, f32


def invariant_terminal_set(*args: Any, **kwargs: Any):
    raise NotImplementedError(
        "invariant_terminal_set (terminal kind 'neighborhood') is not ported "
        "yet (ROADMAP Queue 1, 'Neighborhood terminal sets')"
    )


def create_terminal_ingredient(
    system: Any,
    kind: str,
    references: References,
    weights: Weights,
) -> TerminalIngredient:
    """Synthesize the terminal ingredient for a discrete linear system."""
    if kind not in ("none", "equality", "contractive", "neighborhood"):
        raise ValueError(f"unknown terminal ingredient kind {kind!r}")
    if kind == "neighborhood":
        invariant_terminal_set()
    A, B = linearize(system, references.x[:, -1], references.u[:, -1])
    P = sla.solve_discrete_are(
        np.asarray(A, np.float64),
        np.asarray(B, np.float64),
        np.asarray(weights.Q, np.float64),
        np.asarray(weights.R, np.float64),
    )
    return TerminalIngredient(kind=kind, P=f32(P))
