"""The ctypes signatures of the kernel library against the C sources.

The library is built and loaded only on a machine with a card, so this is
the one check that runs everywhere: every ``extern "C"`` entry of
``csrc/*.cu`` has a row in ``_build.SIGNATURES`` with the same parameters
in the same order, and no row names a missing entry."""

import glob
import os
import re

from automationlabsmodelpredictivecontrol_jl_torch.ops import _build

_ENTRY = re.compile(r"^int\s+(\w+)\(([^)]*)\)\s*\{", re.MULTILINE)


def _kind(param: str) -> str:
    param = param.strip()
    if "*" in param:
        return "p"
    return {"int": "i", "float": "f"}[param.split()[0]]


def _c_entries():
    entries = {}
    for path in sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cu"))):
        text = open(path).read()
        if 'extern "C" {' not in text:  # a register tier of K3: no entry of its own
            continue
        body = text[text.index('extern "C" {'):]
        for name, params in _ENTRY.findall(body):
            entries[name] = "".join(_kind(p) for p in params.split(","))
    return entries


def test_signatures_match_the_c_entries():
    entries = _c_entries()
    assert set(entries) == set(_build.SIGNATURES)
    for name, params in entries.items():
        assert _build.SIGNATURES[name] == params, name
        assert params.endswith("p"), f"{name}: the stream comes last"
