"""Carry a designed controller across from numpy arrays.

``controller_from_numpy`` takes a controller's designed arrays as numpy
(for example those of the JAX package's controller) and returns this
package's ``MpcController`` on a given device, so both packages can be
driven from the very same operator.
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
    of K, G, AmBK, A, B; other keys, such as the JAX operator's doubling
    levels, are not read) and the config's values."""
    grid = tuple(float(r) for r in op["rho_grid"])
    scale = float(op["term_rho_scale"])
    arrays = ("Q", "P_term", "R_in", "x_lo", "x_hi", "xN_lo", "xN_hi", "u_lo", "u_hi")
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
