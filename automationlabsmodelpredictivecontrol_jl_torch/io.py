"""Controller checkpoint and resume, in the JAX package's .npz format.

A checkpoint holds the design spec and the runtime state: the system
(linear matrices, or a zoo family's parameters and the recorded
activation), the constraint boxes, the references, the full weight
matrices, the engine's config (AdmmConfig, RiccatiConfig or SqpConfig,
with its nested ADMM config), the soft state penalty, the terminal kind,
the pinned state and the warm pair. Loading re-runs the design on the
host and restores the runtime state, so a receding-horizon loop resumes
where it stopped. The format (version 2: arrays plus one JSON ``__meta__``
entry) is the JAX package's, so each package loads the other's files.
Economic controllers carry Python cost callables and are refused, as is a
plant of a family the zoo does not register (a Takagi-Sugeno system); a
MILP controller is re-designed from its plant and tuning.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

import numpy as np
import torch

from .design import LinearEngine, MpcController, RiccatiEngine, design_controller
from .models import zoo
from .ops.admm import AdmmConfig
from .ops.riccati import RiccatiConfig
from .solvers.empc import EmpcEngine
from .solvers.sqp import SqpConfig, SqpEngine
from .systems import LinearDiscreteSystem, NeuralDiscreteSystem
from .types import Box
from .utils.devices import resolve_device

_FMT_VERSION = 2
_CONFIGS = {"AdmmConfig": AdmmConfig, "RiccatiConfig": RiccatiConfig, "SqpConfig": SqpConfig}


def _np(v: Any) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _flatten(prefix: str, tree: Any, out: Dict[str, np.ndarray]) -> Any:
    """A parameter tree as npz keys; returns the JSON skeleton of its
    structure (dict keys sorted, as the JAX package writes them)."""
    if isinstance(tree, dict):
        return {k: _flatten(f"{prefix}.{k}", v, out) for k, v in sorted(tree.items())}
    if isinstance(tree, (list, tuple)):
        return [_flatten(f"{prefix}[{i}]", v, out) for i, v in enumerate(tree)]
    out[prefix] = _np(tree)
    return {"__leaf__": prefix}


def _unflatten(skel: Any, data) -> Any:
    if isinstance(skel, dict):
        if set(skel) == {"__leaf__"}:
            return torch.from_numpy(np.array(data[skel["__leaf__"]], np.float32))
        return {k: _unflatten(v, data) for k, v in skel.items()}
    if isinstance(skel, list):
        return [_unflatten(v, data) for v in skel]
    raise ValueError(f"bad skeleton node {skel!r}")


def _config_to_json(cfg: Any) -> Any:
    """A frozen config dataclass as a JSON-able dict (tuples tagged, nested
    configs recursed)."""
    if cfg is None:
        return None
    out: Dict[str, Any] = {"__class__": type(cfg).__name__}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _config_to_json(v)
        elif isinstance(v, tuple):
            out[f.name] = {"__tuple__": list(v)}
        else:
            out[f.name] = v
    return out


def _config_from_json(d: Any) -> Any:
    if d is None:
        return None
    d = dict(d)
    name = d.pop("__class__")
    if name not in _CONFIGS:
        raise ValueError(f"unknown config class {name!r} in checkpoint")
    kwargs = {}
    for k, v in d.items():
        if isinstance(v, dict) and "__tuple__" in v:
            kwargs[k] = tuple(v["__tuple__"])
        elif isinstance(v, dict) and "__class__" in v:
            kwargs[k] = _config_from_json(v)
        else:
            kwargs[k] = v
    return _CONFIGS[name](**kwargs)


def _engine_spec(controller: MpcController) -> Dict[str, Any]:
    """The engine's design arguments that must survive the round trip."""
    eng = controller.engine
    spec: Dict[str, Any] = {
        "admm_config": None,
        "sqp_config": None,
        "riccati_config": None,
        "engine": None,
        "soft_state_penalty": None,
    }
    if isinstance(eng, LinearEngine):
        spec["engine"] = "condensed"
        spec["admm_config"] = _config_to_json(eng.config)
        if eng.soft_mu is not None:
            mu = _np(eng.soft_mu)
            finite = mu[np.isfinite(mu)]
            if finite.size:
                spec["soft_state_penalty"] = float(finite.min())
    elif isinstance(eng, RiccatiEngine):
        spec["engine"] = "riccati"
        spec["riccati_config"] = _config_to_json(eng.config)
    elif isinstance(eng, SqpEngine):
        spec["sqp_config"] = _config_to_json(eng.config)
        if eng.soft_boxes:
            spec["soft_state_penalty"] = float(eng.config.soft_state_penalty)
    elif isinstance(eng, EmpcEngine):
        raise ValueError(
            "economic controllers carry arbitrary Python cost callables and "
            "cannot be checkpointed; rebuild with design_controller("
            "economic_cost=...) and restore warm state manually"
        )
    # a MILP engine rebuilds from (system, tuning): nothing more to keep
    return spec


def save_controller(path: str, controller: MpcController) -> None:
    """Write the controller to ``path`` (.npz)."""
    t = controller.tuning
    sys = controller.system
    if sys is None:
        raise ValueError("a controller without a plant cannot be re-designed on load")
    arrays: Dict[str, np.ndarray] = {
        "X.lo": _np(sys.X.lo),
        "X.hi": _np(sys.X.hi),
        "U.lo": _np(sys.U.lo),
        "U.hi": _np(sys.U.hi),
        "x_ref": _np(t.references.x[:, 0]),
        "u_ref": _np(t.references.u[:, 0]),
        "initialization": _np(controller.initialization),
        "warm_z": _np(controller.warm_z),
        "warm_y": _np(controller.warm_y),
        "Q": _np(t.weights.Q),
        "R": _np(t.weights.R),
        "S": _np(t.weights.S),
    }
    meta: Dict[str, Any] = {
        "version": _FMT_VERSION,
        "horizon": t.horizon,
        "sample_time": t.sample_time,
        "max_time": t.max_time,
        "programming_type": t.programming_type,
        "solver": t.solver_name,
        "terminal": t.terminal.kind,
        "state_constraint": t.state_constraint,
    }
    meta.update(_engine_spec(controller))
    if isinstance(sys, LinearDiscreteSystem):
        meta["system_kind"] = "linear_discrete"
        arrays["A"] = _np(sys.A)
        arrays["B"] = _np(sys.B)
    elif isinstance(sys, NeuralDiscreteSystem):
        if sys.family not in zoo._APPLIES:
            raise ValueError(
                f"cannot serialize neural system of unregistered family "
                f"{sys.family!r}; registered: {sorted(zoo._APPLIES)}"
            )
        meta["system_kind"] = "neural_discrete"
        meta["family"] = sys.family
        meta["nx"] = sys.nx
        meta["nu"] = sys.nu
        meta["activation"] = sys.activation or zoo.default_activation(sys.family)
        meta["params_skeleton"] = _flatten("params", sys.params, arrays)
    else:
        raise ValueError(f"cannot serialize system type {type(sys).__name__}")
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez(path, **arrays)


def load_controller(path: str, device: Any = None) -> MpcController:
    """Re-design a controller from a checkpoint (this package's or the JAX
    package's) on the host, restore its runtime state and move it to
    ``device`` (``None``: the card, raising where there is none)."""
    dev = resolve_device(device)
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
    if meta["version"] not in (1, _FMT_VERSION):
        raise ValueError(f"unsupported checkpoint version {meta['version']}")
    t32 = lambda k: torch.from_numpy(np.array(data[k], np.float32))
    X = Box(lo=t32("X.lo"), hi=t32("X.hi"))
    U = Box(lo=t32("U.lo"), hi=t32("U.hi"))
    if meta["system_kind"] == "linear_discrete":
        system: Any = LinearDiscreteSystem(A=t32("A"), B=t32("B"), X=X, U=U)
    else:
        apply_fn, act = zoo.make_apply(meta["family"], meta["activation"])
        system = NeuralDiscreteSystem(
            apply_fn=apply_fn, family=meta["family"], nx=meta["nx"], nu=meta["nu"],
            params=_unflatten(meta["params_skeleton"], data), X=X, U=U, activation=act,
        )
    # version 1 stored scalar weights in the metadata, version 2 full matrices
    weight = lambda k: data[k] if k in data else meta[k]
    kwargs: Dict[str, Any] = {}
    for key in ("admm_config", "sqp_config", "riccati_config"):
        if meta.get(key) is not None:
            kwargs[key] = _config_from_json(meta[key])
    if meta.get("engine"):
        kwargs["engine"] = meta["engine"]
    if meta.get("soft_state_penalty") is not None:
        kwargs["soft_state_penalty"] = float(meta["soft_state_penalty"])
    ctrl = design_controller(
        system,
        meta["horizon"],
        meta["sample_time"],
        data["x_ref"],
        data["u_ref"],
        programming_type=meta["programming_type"],
        solver=meta["solver"],
        terminal_ingredient=meta["terminal"],
        Q=weight("Q"),
        R=weight("R"),
        S=weight("S"),
        max_time=meta["max_time"],
        state_constraint=meta["state_constraint"],
        device=dev,
        **kwargs,
    )
    return ctrl.replace(
        initialization=t32("initialization").to(dev),
        warm_z=t32("warm_z").to(dev),
        warm_y=t32("warm_y").to(dev),
    )
