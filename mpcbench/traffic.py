"""Traffic: a mix is a data file of parameters, ``traffic/<mix>.json``, and
its ``kind`` names the generator that reads it, ``kinds/<kind>.py``, found
by name as the per-layer metrics' readers are. A mix of a kind that exists
is added as data alone; a new kind is one new file.

A kind's module holds:

- ``KEYS``: the parameters each of its mixes gives, beside ``COMMON``;
- ``check(mix, name)``: raises ValueError where a mix cannot run;
- ``Source(mix, seed, nx, device)``: the batches of initial states drawn
  from the seed (``next()``), and ``sample(batch, rows)``, the lanes of a
  batch that a run compares, drawn from the seed;
- ``warm_up(session, source)``: set-up's batches, every shape the window
  uses;
- ``run_window(session, source, seconds, stop=None, keep=True)``: the
  measured window, a ``harness.Window``.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict

COMMON = ("kind", "lanes", "ranks", "who")
_KINDS: Dict[str, object] = {}


def generator(root: str, kind: str):
    """The module ``kinds/<kind>.py`` under the benchmark's folder ``root``."""
    path = os.path.join(root, "kinds", f"{kind}.py")
    if path not in _KINDS:
        if not os.path.isfile(path):
            raise ValueError(f"traffic kind {kind!r}: no generator {path}")
        spec = importlib.util.spec_from_file_location(f"_mpcbench_kind_{len(_KINDS)}_{kind}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _KINDS[path] = module
    return _KINDS[path]


def load(root: str, name: str) -> Dict:
    """The parameters of mix ``name`` (``traffic/<name>.json`` under the
    benchmark's folder ``root``), checked by its kind's generator."""
    with open(os.path.join(root, "traffic", f"{name}.json")) as f:
        mix = json.load(f)
    if "kind" not in mix:
        raise ValueError(f"traffic {name!r}: no 'kind'")
    kind = generator(root, mix["kind"])
    missing = [k for k in COMMON + tuple(kind.KEYS) if k not in mix]
    if missing:
        raise ValueError(f"traffic {name!r}: a {mix['kind']} mix lacks {missing}")
    if mix["lanes"] % mix["ranks"]:
        raise ValueError(f"traffic {name!r}: {mix['lanes']} lanes do not split over {mix['ranks']} ranks")
    kind.check(mix, name)
    return mix
