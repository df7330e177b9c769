"""One rank of the port's sharded solves over gloo, for
tests/test_torch_sharded.py.

Imports torch, numpy and the port only (never jax nor a test file), so that
a spawned rank starts in seconds. Each rank solves every case of ``CASES``
through ``parallel.solve_sharded`` and writes its shards, its diagnostics
and the errors its refusals raise to ``<out_dir>/rank<r>.pt``.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

B = 16
# (name, controller, x0 seed, fused): the JAX package's tests/test_parallel.py
# cases (test_solve_sharded_matches_batch and test_condensed_sharded_fused_
# matches_general on one batch; test_riccati_sharded_fused)
CASES = (
    ("default", "condensed", 0, None),
    ("general", "condensed", 0, False),
    ("riccati", "riccati", 3, True),
)


def x0_batch(n, seed):
    """The JAX test's states: 0.6 + 0.05 N(0, 1), shape (n, 4)."""
    rng = np.random.default_rng(seed)
    return (0.6 + 0.05 * rng.standard_normal((n, 4))).astype(np.float32)


def controllers():
    """The JAX test's module fixtures on the CPU: the QTP at h5 with the
    default AdmmConfig, and at h8 on the Riccati engine."""
    import automationlabsmodelpredictivecontrol_jl_torch as tmpc
    from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp

    plant = qtp.linearized_discrete_system()
    design = lambda N, **kw: tmpc.proceed_controller(
        plant, "model_predictive_control", N, 5.0, [0.65] * 4, [1.2] * 2, device="cpu", **kw)
    return {"condensed": design(5), "riccati": design(8, engine="riccati")}


def _shard(sol, wz, wy, diag):
    return dict(u=sol.u, status=sol.status, iterations=sol.iterations, wz=wz.contiguous(),
                wy=wy.contiguous(), diag={k: getattr(diag, k) for k in diag.__dataclass_fields__})


def _refusal(fn):
    try:
        fn()
    except ValueError as err:
        return str(err)
    return None


def run(rank, world, store, out_dir):
    """Rank ``rank`` of ``world``: join the gloo group through the file
    store, solve every case on a mesh of every rank, then on a mesh of the
    first half of the ranks, and write the results."""
    from automationlabsmodelpredictivecontrol_jl_torch import parallel

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        ctrls = controllers()
        mesh = parallel.make_mesh()
        out = {"mesh": (mesh.n, mesh.rank, mesh.axis), "jax_imported": "jax" in sys.modules}
        for name, kind, seed, fused in CASES:
            x0s = torch.from_numpy(x0_batch(B, seed))
            out[name] = _shard(*parallel.solve_sharded(ctrls[kind], x0s, mesh, fused=fused))
        x0s = torch.from_numpy(x0_batch(B, 0))
        out["not_divisible"] = _refusal(
            lambda: parallel.solve_sharded(ctrls["condensed"], x0s[: B - 1], mesh))
        out["too_many_ranks"] = _refusal(lambda: parallel.make_mesh(world + 1))
        half = parallel.make_mesh(world // 2)  # every rank of the world creates it
        out["half_mesh"] = (half.n, half.rank)
        if half.rank >= 0:
            out["half"] = _shard(*parallel.solve_sharded(ctrls["condensed"], x0s, half))
        else:
            out["outside"] = _refusal(
                lambda: parallel.solve_sharded(ctrls["condensed"], x0s, half))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
