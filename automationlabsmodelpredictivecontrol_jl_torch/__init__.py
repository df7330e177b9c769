"""Model predictive control in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper.

The port of ``automationlabsmodelpredictivecontrol_jl_tpu`` (JAX/Pallas),
which stays beside it as the reference. This package imports torch, numpy
and scipy, and never jax. Ported so far: controller design for linear
plants (condensed QP, ADMM operator; the Riccati factorization) and for
learned plants (the model zoo, ``models/zoo.py``; the SQP engine, single
and multiple shooting, ``solvers/sqp.py``; or the linear engines on the
plant's linearization), Takagi-Sugeno fuzzy plants (the SQP), economic
MPC (``solvers/empc.py``), exact-ReLU MILP control on the host's native
branch and bound (``solvers/milp.py``), checkpoints (``io.py``), the runtime
(``solve_once``, ``step``, ``calculate``, the reference updates) on the
general ADMM engine, the per-lane Riccati engine and the SQP, the batched
fused ADMM solves on the kernels K1 (``csrc/admm_diag.cu``), K2
(``csrc/admm_mixed.cu``), K4 and K5 (``csrc/admm_perr.cu``), the
long-horizon Riccati-ADMM solve on K3 (``csrc/riccati_chunk.cuh``),
tiered straggler escalation with the native f64 oracle, batched closed
loops, scenario-sharded solves over ``torch.distributed``
(``parallel.solve_sharded``), and the profiling and H100 roofline
utilities (``utils/profiling.py``, ``utils/roofline.py``). Every
controller the JAX package designs, this package designs and solves.

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
    NeuralContinuousSystem,
    NeuralDiscreteSystem,
    as_discrete,
    discretize,
    linearize,
    linearize_to_system,
    takagi_sugeno_system,
    user_function_system,
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
from .solvers.empc import EmpcConfig, EmpcEngine  # noqa: E402
from .solvers.sqp import SqpConfig, SqpEngine  # noqa: E402
from .models.zoo import MODEL_FAMILIES, init_model, make_system, rollout  # noqa: E402
from .io import load_controller, save_controller  # noqa: E402
from .runtime import (  # noqa: E402
    calculate,
    solve_once,
    step,
    update_and_compute,
    update_initialization,
    update_references,
)
from .terminal import create_terminal_ingredient, invariant_terminal_set  # noqa: E402

__all__ = [
    "AdmmConfig",
    "Box",
    "DEFAULT_PARAMETERS",
    "EmpcConfig",
    "EmpcEngine",
    "LinearContinuousSystem",
    "LinearDiscreteSystem",
    "LinearEngine",
    "MODEL_FAMILIES",
    "MpcController",
    "MpcSolution",
    "MpcTuning",
    "NeuralContinuousSystem",
    "NeuralDiscreteSystem",
    "References",
    "RiccatiConfig",
    "RiccatiEngine",
    "STATUS_CONVERGED",
    "STATUS_DUAL_INFEASIBLE",
    "STATUS_MAX_ITER",
    "STATUS_NAMES",
    "STATUS_NUMERIC_ERROR",
    "STATUS_PRIMAL_INFEASIBLE",
    "SqpConfig",
    "SqpEngine",
    "TerminalIngredient",
    "Weights",
    "as_discrete",
    "calculate",
    "create_terminal_ingredient",
    "create_weights",
    "design_controller",
    "design_references",
    "discretize",
    "init_model",
    "invariant_terminal_set",
    "linearize",
    "linearize_to_system",
    "load_controller",
    "make_system",
    "proceed_controller",
    "rollout",
    "save_controller",
    "solve_once",
    "step",
    "takagi_sugeno_system",
    "update_and_compute",
    "update_initialization",
    "update_references",
    "user_function_system",
]
