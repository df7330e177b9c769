"""Model predictive control in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper.

The port of ``automationlabsmodelpredictivecontrol_jl_tpu`` (JAX/Pallas),
which stays beside it as the reference. This package imports torch, numpy
and scipy, and never jax. Ported so far: controller design for linear
plants (condensed QP, ADMM operator; the Riccati factorization), the
batched fused ADMM solve on the diagonal-A kernel K1
(``csrc/admm_diag.cu``) and the mixed-A kernel K2 (``csrc/admm_mixed.cu``),
the long-horizon Riccati-ADMM solve on K3 (``csrc/riccati_admm.cu``),
tiered straggler escalation with the native f64 oracle, and batched closed
loops. See ROADMAP.md for
what remains.

Importing the package pins float32 matmuls to IEEE fp32 (no TF32): the
solver's certificates sit at 1e-6, far below what TF32 keeps.
"""

from .utils.precision import pin_ieee_fp32 as _pin_ieee_fp32

_pin_ieee_fp32()

from .types import (  # noqa: E402
    Box,
    MpcSolution,
    References,
    STATUS_CONVERGED,
    STATUS_DUAL_INFEASIBLE,
    STATUS_MAX_ITER,
    STATUS_NAMES,
    STATUS_NUMERIC_ERROR,
    STATUS_PRIMAL_INFEASIBLE,
    TerminalIngredient,
    Weights,
    design_references,
)
from .systems import (  # noqa: E402
    LinearContinuousSystem,
    LinearDiscreteSystem,
    as_discrete,
    discretize,
    linearize,
)
from .design import (  # noqa: E402
    LinearEngine,
    MpcController,
    MpcTuning,
    RiccatiEngine,
    create_weights,
    design_controller,
)
from .main import DEFAULT_PARAMETERS, proceed_controller  # noqa: E402
from .ops.admm import AdmmConfig  # noqa: E402
from .ops.riccati import RiccatiConfig  # noqa: E402
from .terminal import create_terminal_ingredient  # noqa: E402

__all__ = [
    "AdmmConfig",
    "Box",
    "DEFAULT_PARAMETERS",
    "LinearContinuousSystem",
    "LinearDiscreteSystem",
    "LinearEngine",
    "MpcController",
    "MpcSolution",
    "MpcTuning",
    "References",
    "RiccatiConfig",
    "RiccatiEngine",
    "STATUS_CONVERGED",
    "STATUS_DUAL_INFEASIBLE",
    "STATUS_MAX_ITER",
    "STATUS_NAMES",
    "STATUS_NUMERIC_ERROR",
    "STATUS_PRIMAL_INFEASIBLE",
    "TerminalIngredient",
    "Weights",
    "as_discrete",
    "create_terminal_ingredient",
    "create_weights",
    "design_controller",
    "design_references",
    "discretize",
    "linearize",
    "proceed_controller",
]
