"""Solver selection: programming-type × solver admissibility + `auto` rules.

API parity with the reference's solver layer (solver_selection.jl):

- registry `_IMPLEMENTATION_SOLVER_LIST = (osqp, scip, ipopt, auto)`
  (solver_selection.jl:9-14),
- admissibility: LinearProgramming → {osqp, scip, ipopt} (:18-31),
  NonLinearProgramming → {ipopt, scip} (:33-42), MILP → {scip} (:44-53),
- `auto`: linear → scip (:56-65), non_linear → ipopt (:67-76),
  mixed → scip (:78-87).

The *names* are kept for drop-in parity, but every name maps to an
in-house engine: linear programs solve on the batched ADMM QP engine
(the OSQP-equivalent), nonlinear programs on the SQP engine (the
Ipopt-equivalent), and mixed-integer programs on the in-house
branch-and-bound MIQP solver in the native C++ runtime (the
SCIP-equivalent; big-M ReLU transcription in solvers/milp.py, host-side —
ReLU-network MPC on TPU is better served by the exact nonlinear path).
"""

from __future__ import annotations

PROGRAMMING_TYPES = ("linear", "non_linear", "mixed_linear", "fuzzy_linear")

SOLVER_LIST = ("osqp", "scip", "ipopt", "auto")

_ADMISSIBLE = {
    "linear": ("osqp", "scip", "ipopt"),
    "non_linear": ("ipopt", "scip"),
    "mixed_linear": ("scip",),
    "fuzzy_linear": ("ipopt", "scip"),
}

_AUTO = {
    "linear": "scip",  # parity quirk: auto-linear is SCIP, not OSQP (:56-65)
    "non_linear": "ipopt",
    "mixed_linear": "scip",
    "fuzzy_linear": "ipopt",
}

# which in-house engine implements each (programming_type, solver) pair
_ENGINE = {
    "linear": "admm",
    "non_linear": "sqp",
    "mixed_linear": "milp",  # native C++ branch-and-bound (SCIP-equivalent)
    # Takagi-Sugeno: an orphaned tag in the reference (types.jl:223) and a
    # CHANGELOG roadmap item there — implemented here via the SQP engine
    # over blended TS dynamics (systems.takagi_sugeno_system)
    "fuzzy_linear": "sqp",
}


def resolve_solver(programming_type: str, solver_name: str) -> str:
    """Validate + resolve a solver name ('auto' included) for a programming
    type; returns the resolved solver *name* (reference-vocabulary)."""
    if programming_type not in _ADMISSIBLE:
        raise ValueError(
            f"unknown programming type {programming_type!r}; "
            f"available: {PROGRAMMING_TYPES}"
        )
    if solver_name == "auto":
        return _AUTO[programming_type]
    if solver_name not in SOLVER_LIST:
        raise ValueError(
            f"unknown solver {solver_name!r}; available: {SOLVER_LIST}"
        )
    if solver_name not in _ADMISSIBLE[programming_type]:
        raise ValueError(
            f"solver {solver_name!r} not admissible for programming type "
            f"{programming_type!r} (admissible: {_ADMISSIBLE[programming_type]})"
        )
    return solver_name


def engine_for(programming_type: str) -> str:
    """In-house engine backing a programming type: 'admm', 'sqp' or 'milp'."""
    return _ENGINE[programming_type]
