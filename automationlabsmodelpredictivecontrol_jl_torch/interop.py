"""Carry designed controllers and learned weights across from numpy.

``controller_from_numpy`` takes a controller's designed arrays as numpy
(for example those of the JAX package's controller) and returns this
package's ``MpcController`` on a given device, so both packages can be
driven from the very same operator. ``params_from_numpy`` and
``unravel_params`` carry a learned model's weights: a parameter tree of
numpy arrays, or the flat vector that ``jax.flatten_util.ravel_pytree``
makes of one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch

from .design import LinearEngine, MpcController, MpcTuning, RiccatiEngine
from .ops.admm import AdmmConfig, AdmmOperator, packed_kia
from .ops.condense import CondensedQpData
from .ops.riccati import RiccatiConfig, RiccatiFactors, RiccatiOperator, rho_table
from .types import References, TerminalIngredient, Weights
from .utils.devices import resolve_device


def _f32(v: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32))


def params_from_numpy(family: str, tree: Any) -> Any:
    """A zoo family's parameter tree from numpy (dicts, lists, arrays):
    the same tree of float32 CPU tensors, leaf for leaf (the JAX package's
    names and shapes are the port's)."""
    from .models import zoo

    if family not in zoo._APPLIES:
        raise ValueError(f"unknown model family {family!r}; see zoo.MODEL_FAMILIES")
    if isinstance(tree, dict):
        return {k: params_from_numpy(family, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(family, v) for v in tree]
    return _f32(tree)


def _ravel_leaves(tree: Any):
    """The leaves of a parameter tree in ``ravel_pytree``'s order: a
    dict's entries by sorted key (so "W" < "W_in" < "W_out" < "b" < "b_in"),
    a list's in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _ravel_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in _ravel_leaves(v)]
    return [tree]


def _fill(tree: Any, values) -> Any:
    if isinstance(tree, dict):
        return {k: _fill(tree[k], values) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_fill(v, values) for v in tree]
    return next(values)


def unravel_params(
    family: str,
    nx: int,
    nu: int,
    hidden: int,
    depth: int,
    flat: Any,
    sample_time: float = 1.0,
) -> Any:
    """The parameter tree of a zoo model from the flat vector that
    ``ravel_pytree`` made of it (float32 CPU tensors). The tree's
    structure is the family's at (nx, nu, hidden, depth); the leaves are
    cut from ``flat`` in ravel order (:func:`_ravel_leaves`). For the
    golden fnn (4, 2, 8, 1) that is W (1, 8, 8), W_in (8, 6), W_out
    (4, 8), b (1, 8), b_in (8,): 160 floats."""
    from .models import zoo

    _, template = zoo.init_model(
        family, 0, nx, nu, hidden=hidden, depth=depth, sample_time=sample_time
    )
    flat = np.asarray(flat).reshape(-1)
    sizes = [int(leaf.numel()) for leaf in _ravel_leaves(template)]
    if flat.size != sum(sizes):
        raise ValueError(
            f"{family} at nx={nx}, nu={nu}, hidden={hidden}, depth={depth} has "
            f"{sum(sizes)} parameters, the vector {flat.size}"
        )
    offsets = np.cumsum([0] + sizes)
    pieces = iter(
        _f32(flat[o : o + leaf.numel()]).reshape(leaf.shape)
        for o, leaf in zip(offsets, _ravel_leaves(template))
    )
    return _fill(template, pieces)


def _record(cls, values: Mapping[str, Any]):
    """Build a dataclass of tensors: array fields become float32 CPU
    tensors (bit-exact copies of float32 input), other fields pass as is."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = values[f.name]
        if isinstance(v, (bool, int, float, str)) or v is None:
            kwargs[f.name] = v
        else:
            kwargs[f.name] = _f32(v)
    return cls(**kwargs)


def _riccati_engine(op: Mapping[str, Any], config: Mapping[str, Any]) -> RiccatiEngine:
    """A Riccati engine from the operator's fields (``factors`` a mapping
    of K, G, AmBK, A, B; the doubling levels ``bwd_levels``, ``bwd_full``,
    ``fwd_levels``, ``fwd_full`` carried as they are) and the config's
    values."""
    grid = tuple(float(r) for r in op["rho_grid"])
    scale = float(op["term_rho_scale"])
    arrays = ("Q", "P_term", "R_in", "x_lo", "x_hi", "xN_lo", "xN_hi", "u_lo", "u_hi",
              "bwd_levels", "bwd_full", "fwd_levels", "fwd_full")
    operator = RiccatiOperator(
        factors=_record(RiccatiFactors, op["factors"]),
        rho_grid=grid,
        rho0=float(op["rho0"]),
        rho_tab=rho_table(grid, scale),
        term_rho_scale=scale,
        **{k: _f32(op[k]) for k in arrays},
        **{k: int(op[k]) for k in ("N", "nx", "nu")},
        **{k: bool(op[k]) for k in ("split_interior", "split_terminal", "terminal_ball")},
    )
    cfg = RiccatiConfig(
        **{k: (tuple(float(r) for r in v) if k == "rho_grid" and v is not None else v)
           for k, v in config.items()}
    )
    return RiccatiEngine(op=operator, config=cfg)


def controller_from_numpy(
    *,
    qp: Optional[Mapping[str, Any]] = None,
    op: Mapping[str, Any],
    references: Mapping[str, Any],
    weights: Mapping[str, Any],
    terminal_P: Any,
    terminal_H: Any = None,
    terminal_b: Any = None,
    config: Mapping[str, Any],
    tuning: Mapping[str, Any],
    device: Any = None,
) -> MpcController:
    """A condensed-engine or Riccati-engine controller from designed arrays.

    - ``qp``: the ``CondensedQpData`` fields (arrays, and N, nx, nu,
      n_ball, ball_radius_sq_factor); None for a Riccati engine;
    - ``op``: the ``AdmmOperator`` fields, with diag_a, mixed_a, n_ball
      (``kia`` may be left out: it is formed here for a dense operator,
      one whose rows are not box-first);
      or, for a Riccati engine, the ``RiccatiOperator`` fields: its
      ``factors`` (K, G, AmBK, A, B), bounds, flags, rho_grid, rho0 and
      term_rho_scale;
    - ``references`` {x, u}, ``weights`` {Q, R, S}, the terminal cost
      ``terminal_P`` and, for a neighborhood terminal, its set
      ``terminal_H``, ``terminal_b`` (H e_x_N <= b);
    - ``config``: the ``AdmmConfig`` (or ``RiccatiConfig``) values;
    - ``tuning``: horizon, sample_time, max_time, programming_type,
      solver_name, state_constraint and terminal_kind.

    The controller has no plant (``system=None``) and zero warm state. It
    is moved to ``device``: ``None`` is the card, and raises where there
    is none.
    """
    dev = resolve_device(device)
    tun = MpcTuning(
        references=_record(References, references),
        weights=_record(Weights, weights),
        terminal=TerminalIngredient(
            kind=str(tuning["terminal_kind"]),
            P=_f32(terminal_P),
            H=None if terminal_H is None else _f32(terminal_H),
            b=None if terminal_b is None else _f32(terminal_b),
        ),
        horizon=int(tuning["horizon"]),
        sample_time=float(tuning["sample_time"]),
        max_time=float(tuning["max_time"]),
        programming_type=str(tuning["programming_type"]),
        solver_name=str(tuning["solver_name"]),
        state_constraint=bool(tuning["state_constraint"]),
    )
    if qp is None:
        engine = _riccati_engine(op, config)
        N, nx, nu = engine.op.N, engine.op.nx, engine.op.nu
        n, m = N * nu, (N + 1) * nx + N * nu
    else:
        ops = {k: (int(v) if k == "n_ball" else v) for k, v in op.items()}
        ops["diag_a"] = bool(op["diag_a"])
        ops["mixed_a"] = bool(op["mixed_a"])
        ops.setdefault("kia", None)
        cfg = AdmmConfig(
            **{
                k: (tuple(float(r) for r in v) if k == "rho_grid" else v)
                for k, v in config.items()
            }
        )
        operator = _record(AdmmOperator, ops)
        if operator.dense_a and operator.kia is None:
            operator = operator.replace(kia=packed_kia(operator.K_invs, operator.A_s))
        m, n = operator.A_s.shape
        engine = LinearEngine(
            qp=_record(CondensedQpData, qp), op=operator, soft_mu=None, config=cfg
        )
    return MpcController(
        system=None,
        tuning=tun,
        engine=engine,
        initialization=torch.zeros((tun.references.x.shape[0],), dtype=torch.float32),
        warm_z=torch.zeros((n,), dtype=torch.float32),
        warm_y=torch.zeros((m,), dtype=torch.float32),
        results=None,
    ).to(dev)
