"""The scenario-sharded solve over torch.distributed, port vs JAX: worlds of
2 and 4 gloo ranks on the CPU, each a spawned process that runs
tests/torch_sharded_worker.py (torch, numpy and the port only), started
once for the module and joined when a test first needs its results.

Mirrors the JAX package's tests/test_parallel.py (test_solve_sharded_
matches_batch, test_sharded_batch_size_check, and the slow-marked
test_riccati_sharded_fused and test_condensed_sharded_fused_matches_general)
and tests/test_multihost.py's cross-process diagnostics: each rank's lanes
equal a local solve of its rows bit for bit, the diagnostics are the same
bits on every rank and equal the shards' combined, and the gathered shards
agree with the JAX package's solve_sharded on make_mesh(n) over the 8
virtual CPU devices at its tests' bars. The Riccati shards stay at 8 lanes
(JAX pads fused Riccati batches above 128 lanes)."""

import multiprocessing
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import automationlabsmodelpredictivecontrol_jl_tpu as jmpc
from automationlabsmodelpredictivecontrol_jl_tpu import parallel as jpar
from automationlabsmodelpredictivecontrol_jl_tpu.benchmarks import qtp as jqtp

from automationlabsmodelpredictivecontrol_jl_torch import parallel as tpar
from automationlabsmodelpredictivecontrol_jl_torch.parallel import scenarios as tscen

import torch_sharded_worker as worker

torch.set_num_threads(1)

WORLDS = (2, 4)
U_TOL, FUSED_TOL = 2e-4, 5e-4  # JAX tests/test_parallel.py: sharded vs batch; fused vs general
JOIN_S = 300


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Start every world's ranks at once; they run while the JAX references
    compile."""
    ctx = multiprocessing.get_context("spawn")
    worlds = {}
    for world in WORLDS:
        out = tmp_path_factory.mktemp(f"world{world}")
        store = str(out / "store")
        procs = [ctx.Process(target=worker.run, args=(r, world, store, str(out)))
                 for r in range(world)]
        for p in procs:
            p.start()
        worlds[world] = (procs, out)
    yield worlds
    for procs, _ in worlds.values():
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)


@pytest.fixture(scope="module")
def ranks(spawned):
    """world -> the results of each rank, in rank order."""
    loaded = {}

    def get(world):
        if world not in loaded:
            procs, out = spawned[world]
            for p in procs:
                p.join(JOIN_S)
            assert not any(p.is_alive() for p in procs), f"world {world} did not finish"
            assert [p.exitcode for p in procs] == [0] * world
            loaded[world] = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(world)]
        return loaded[world]

    return get


@pytest.fixture(scope="module")
def ctrls():
    return worker.controllers()


@pytest.fixture(scope="module")
def jax_ctrls():
    plant = jqtp.linearized_discrete_system()
    design = lambda N, **kw: jmpc.proceed_controller(
        plant, "model_predictive_control", N, 5.0, np.full(4, 0.65), np.full(2, 1.2), **kw)
    return {"condensed": design(5), "riccati": design(8, engine="riccati")}


def _jax_sharded(jax_ctrls, world, name):
    """The JAX package's solve_sharded of a case: u, statuses and its fleet
    diagnostics (replicated), as numpy."""
    _, kind, seed, fused = next(c for c in worker.CASES if c[0] == name)
    x0s = jnp.asarray(worker.x0_batch(worker.B, seed))
    sol, _, _, diag = jpar.solve_sharded(jax_ctrls[kind], x0s, jpar.make_mesh(world),
                                         fused=fused)
    diag = {k: np.asarray(getattr(diag, k)) for k in diag.__dataclass_fields__}
    return np.asarray(sol.u), np.asarray(sol.status), diag


def _assert_diag_matches_jax(ours, theirs, tol, name):
    """Every field of the fleet diagnostics against JAX's: the counts
    exactly, the maximum residuals at the case's u bar, the maximum and the
    mean of iterations (a count, and a sum over n_total) to fp32
    rounding."""
    assert set(ours) == set(theirs), name
    for key in ("n_total", "n_converged", "n_max_iter", "n_infeasible", "max_iterations"):
        assert int(ours[key]) == int(theirs[key]), (name, key)
    for key in ("max_primal_residual", "max_dual_residual"):
        np.testing.assert_allclose(float(ours[key]), float(theirs[key]), atol=tol,
                                   err_msg=f"{name} {key}")
    np.testing.assert_allclose(float(ours["mean_iterations"]), float(theirs["mean_iterations"]),
                               rtol=2 ** -23, err_msg=f"{name} mean_iterations")


def _local(ctrls, name, rows):
    """The case's rows solved in this process, on the path the case takes."""
    _, kind, seed, fused = next(c for c in worker.CASES if c[0] == name)
    ctrl = ctrls[kind]
    fused = tpar.fused_supported(ctrl) if fused is None else fused
    x0s = torch.from_numpy(worker.x0_batch(worker.B, seed))[rows]
    solve = tpar.solve_batch_fused if fused else tpar.solve_batch
    return solve(ctrl, x0s)


def _assert_bits(shard, local):
    sol, wz, wy, diag = local
    for key, want in (("u", sol.u), ("status", sol.status), ("iterations", sol.iterations),
                      ("wz", wz), ("wy", wy)):
        assert torch.equal(shard[key], want), key


def _combined(diags):
    """The shards' diagnostics combined field by field, apart from the
    port's packing: the counts summed, the residuals and max_iterations
    maximised, mean_iterations weighted by n_total (in fp64), each in its
    field's dtype."""
    field = lambda k: [getattr(d, k) for d in diags]
    like = diags[0]
    out = {k: torch.stack([v.double() for v in field(k)]).sum(0).to(getattr(like, k).dtype)
           for k in ("n_total", "n_converged", "n_max_iter", "n_infeasible")}
    out.update({k: torch.stack(field(k)).amax(0)
                for k in ("max_primal_residual", "max_dual_residual", "max_iterations")})
    its = torch.stack([d.mean_iterations.double() * d.n_total.double() for d in diags]).sum(0)
    total = torch.stack([d.n_total.double() for d in diags]).sum(0)
    out["mean_iterations"] = (its / total).to(like.mean_iterations.dtype)
    return tscen.BatchDiagnostics(**out)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", [c[0] for c in worker.CASES])
def test_shards_equal_local_solves(ranks, ctrls, world, name):
    """Each rank's lanes equal a solve of its rows alone in this process
    (the Riccati engine's batch-wide rho rule runs per shard), and its
    diagnostics are the same bits on every rank and equal the shards'
    combined."""
    res = ranks(world)
    b = worker.B // world
    locals_ = [_local(ctrls, name, slice(r * b, (r + 1) * b)) for r in range(world)]
    for r in range(world):
        assert res[r]["mesh"] == (world, r, tpar.SCENARIO_AXIS)
        assert res[r]["jax_imported"] is False
        _assert_bits(res[r][name], locals_[r])
    want = _combined([d for _, _, _, d in locals_])
    for r in range(world):
        for key, v in res[r][name]["diag"].items():
            assert v.dtype == getattr(want, key).dtype, key
            assert torch.equal(v, getattr(want, key)), (key, r)
    assert int(want.n_total) == worker.B


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_matches_jax(ranks, jax_ctrls, world):
    """The gathered shards against the JAX package's solve_sharded on a mesh
    of as many devices: the general engine at 2e-4 (JAX's sharded-vs-batch
    bar), the port's default route (fused: K1's plain version) at 5e-4
    against JAX's default (its vmapped engine at h5's R = 5 with
    refinement), the Riccati engine's fused path at 2e-4; statuses and
    converged counts equal."""
    res = ranks(world)
    gather = lambda name, key: torch.cat([res[r][name][key] for r in range(world)]).numpy()
    general = _jax_sharded(jax_ctrls, world, "general")
    for name, ref, tol in (("general", general, U_TOL),
                           ("default", general, FUSED_TOL),
                           ("riccati", _jax_sharded(jax_ctrls, world, "riccati"), U_TOL)):
        u, status, diag = ref
        np.testing.assert_allclose(gather(name, "u"), u, atol=tol, err_msg=name)
        np.testing.assert_array_equal(gather(name, "status"), status, err_msg=name)
        assert int(diag["n_converged"]) == worker.B, name
        for r in range(world):
            _assert_diag_matches_jax(res[r][name]["diag"], diag, tol, name)
    # the JAX package's test_condensed_sharded_fused_matches_general
    np.testing.assert_allclose(gather("default", "u"), gather("general", "u"), atol=FUSED_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_refusals(ranks, world):
    """A batch that does not divide over the ranks and a mesh larger than
    the group raise ValueError on every rank."""
    for res in ranks(world):
        assert "divisible" in res["not_divisible"]
        assert f"{world} ranks" in res["too_many_ranks"]


@pytest.mark.parametrize("world", WORLDS)
def test_sub_mesh(ranks, ctrls, world):
    """make_mesh(n) below the world size takes ranks 0..n-1: they solve the
    batch between them, and the others are outside the mesh."""
    res = ranks(world)
    n = world // 2
    b = worker.B // n
    for r in range(world):
        assert res[r]["half_mesh"] == (n, r if r < n else -1)
        if r < n:
            _assert_bits(res[r]["half"], _local(ctrls, "default", slice(r * b, (r + 1) * b)))
            assert int(res[r]["half"]["diag"]["n_total"]) == worker.B
        else:
            assert "not a rank" in res[r]["outside"]


def test_make_mesh_without_group():
    """Without a process group the mesh is this process alone: asking for
    more ranks raises, as the JAX package's make_mesh never shrinks."""
    mesh = tpar.make_mesh()
    assert (mesh.n, mesh.rank, mesh.group, mesh.axis) == (1, 0, None, "scenario")
    assert tpar.make_mesh(1).n == 1
    with pytest.raises(ValueError, match="only rank"):
        tpar.make_mesh(2)


@pytest.mark.parametrize("name", [c[0] for c in worker.CASES])
def test_one_rank_equals_batch_auto(ctrls, name):
    """A one-rank mesh without a group: solve_sharded equals the batch path
    it routes to bit for bit (solve_batch_auto by default), and its
    diagnostics equal the batch's."""
    _, kind, seed, fused = next(c for c in worker.CASES if c[0] == name)
    ctrl = ctrls[kind]
    x0s = torch.from_numpy(worker.x0_batch(worker.B, seed))
    sol, wz, wy, diag = tpar.solve_sharded(ctrl, x0s, fused=fused)
    batch = {None: tpar.solve_batch_auto, True: tpar.solve_batch_fused,
             False: tpar.solve_batch}[fused]
    want = batch(ctrl, x0s)
    _assert_bits(dict(u=sol.u, status=sol.status, iterations=sol.iterations, wz=wz, wy=wy),
                 want)
    for key in diag.__dataclass_fields__:
        assert torch.equal(getattr(diag, key), getattr(want[3], key)), key
    with pytest.raises(ValueError, match="divisible"):
        tpar.solve_sharded(ctrl, x0s, tscen.ScenarioMesh(group=None, n=3, rank=0))
