"""Public entry API, with the reference's keyword vocabulary
(mpc_programming_type, mpc_solver, mpc_terminal_ingredient, mpc_Q/mpc_R/
mpc_S, mpc_max_time, mpc_state_constraint) plus ``device=``."""

from __future__ import annotations

from typing import Any

from .design import MpcController, design_controller

DEFAULT_PARAMETERS = {
    "mpc_solver": "auto",
    "mpc_terminal_ingredient": "none",
    "mpc_Q": 100.0,
    "mpc_R": 0.1,
    "mpc_S": 0.0,
    "mpc_max_time": 30.0,
}

IMPLEMENTATION_CONTROLLER_LIST = (
    "model_predictive_control",
    "economic_model_predictive_control",
)


def proceed_controller(
    system: Any,
    mpc_controller_type: str,
    mpc_horizon: int,
    mpc_sample_time: float,
    mpc_state_reference,
    mpc_input_reference,
    device: Any = None,
    **kws: Any,
) -> MpcController:
    """Design a controller on the host (numpy f64) and move its operator
    to ``device`` ("cuda", "cpu", a torch.device). ``None``, the default,
    is the card (``utils.devices.require_cuda``), and raises where there
    is none: the CPU is used only when the caller names it. Solves then run
    on the device of their input tensors.

    ``"model_predictive_control"``: quadratic tracking MPC, on the condensed
    engine or, with ``engine="riccati"`` or at long horizons, the Riccati
    engine (``riccati_config=``). On a learned plant
    (``NeuralDiscreteSystem``) the SQP engine (``sqp_config=SqpConfig(...)``,
    single or multiple shooting), or with ``mpc_programming_type="linear"``
    the linear engines on its linearization at the first reference; with
    ``mpc_programming_type="mixed_linear"`` on a ReLU network, the exact
    MILP engine (host branch and bound); a ``takagi_sugeno_system`` with
    ``mpc_programming_type="fuzzy_linear"``, the SQP engine.

    ``"economic_model_predictive_control"``: economic MPC over a generic
    stage cost. Requires ``mpc_cost_function``, ``l(x, u) -> scalar`` of
    torch tensors that ``torch.func`` can trace; optional
    ``mpc_terminal_cost_function``, ``Vf(x) -> scalar`` (default: the
    quadratic e_N' P e_N, P from the DARE), and ``empc_config``.
    """
    if mpc_controller_type not in IMPLEMENTATION_CONTROLLER_LIST:
        raise ValueError(
            f"unsupported controller type {mpc_controller_type!r}; "
            f"available: {IMPLEMENTATION_CONTROLLER_LIST}"
        )
    economic = mpc_controller_type == "economic_model_predictive_control"
    if economic and "mpc_cost_function" not in kws:
        raise ValueError(
            "economic_model_predictive_control requires mpc_cost_function "
            "(a stage cost l(x, u) -> scalar)"
        )
    if not economic and "mpc_cost_function" in kws:
        raise ValueError(
            "mpc_cost_function is only accepted with "
            "mpc_controller_type='economic_model_predictive_control'"
        )
    p = dict(DEFAULT_PARAMETERS)
    return design_controller(
        system,
        int(mpc_horizon),
        float(mpc_sample_time),
        mpc_state_reference,
        mpc_input_reference,
        programming_type=kws.get("mpc_programming_type"),
        solver=kws.get("mpc_solver", p["mpc_solver"]),
        terminal_ingredient=kws.get(
            "mpc_terminal_ingredient", p["mpc_terminal_ingredient"]
        ),
        Q=float(kws.get("mpc_Q", p["mpc_Q"])),
        R=float(kws.get("mpc_R", p["mpc_R"])),
        S=float(kws.get("mpc_S", p["mpc_S"])),
        max_time=float(kws.get("mpc_max_time", p["mpc_max_time"])),
        # presence-flag semantics, like the reference; a soft state
        # constraint implies the state constraint
        state_constraint=(
            ("mpc_state_constraint" in kws and kws["mpc_state_constraint"] is not False)
            or "mpc_soft_state_constraint" in kws
        ),
        soft_state_penalty=(
            float(kws["mpc_soft_state_constraint"])
            if "mpc_soft_state_constraint" in kws
            else None
        ),
        admm_config=kws.get("admm_config"),
        engine=kws.get("engine", "auto"),
        riccati_config=kws.get("riccati_config"),
        sqp_config=kws.get("sqp_config"),
        economic_cost=kws.get("mpc_cost_function"),
        economic_terminal_cost=kws.get("mpc_terminal_cost_function"),
        empc_config=kws.get("empc_config"),
        device=device,
    )
