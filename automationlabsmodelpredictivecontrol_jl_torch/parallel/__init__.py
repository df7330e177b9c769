from .scenarios import (
    BatchDiagnostics,
    closed_loop_batch,
    escalation_controller,
    fused_supported,
    init_warm_batch,
    make_escalated_solver,
    solve_batch,
    solve_batch_auto,
    solve_batch_escalated,
    solve_batch_fused,
)

__all__ = [
    "BatchDiagnostics",
    "closed_loop_batch",
    "escalation_controller",
    "fused_supported",
    "init_warm_batch",
    "make_escalated_solver",
    "solve_batch",
    "solve_batch_auto",
    "solve_batch_escalated",
    "solve_batch_fused",
]
