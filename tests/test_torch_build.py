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


def _c_params(entry):
    """The parameter names of a C entry of csrc/*.cu, in order."""
    for path in sorted(glob.glob(os.path.join(_build.CSRC_DIR, "*.cu"))):
        for name, params in _ENTRY.findall(open(path).read()):
            if name == entry:
                return [p.strip().split()[-1].lstrip("*") for p in params.split(",")]
    raise AssertionError(f"no C entry {entry}")


def test_k2_entry_takes_the_plan():
    """admm_mixed_chunk's int parameters are the ones the wrapper passes,
    in its order (admm_fused.K2_INTS: the shape, then k2_plan's layout)."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    params = _c_params("admm_mixed_chunk")
    sig = _build.SIGNATURES["admm_mixed_chunk"]
    ints = [p for p, kind in zip(params, sig) if kind == "i"]
    assert tuple(ints) == admm_fused.K2_INTS
    assert sig == "p" * 18 + "i" * len(admm_fused.K2_INTS) + "ff" + "p"


def test_k2_instantiations_match_the_plan():
    """The rows per thread K2 instantiates (MPC_K2_RPT_N / _T in
    csrc/admm_mixed.cu) are the ones k2_plan may pick."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    text = open(os.path.join(_build.CSRC_DIR, "admm_mixed.cu")).read()
    box = re.search(r"#define MPC_K2_RPT_N\(X\) (.*)", text).group(1)
    tail = re.search(r"#define MPC_K2_RPT_T\(N, X\) (.*)", text).group(1)
    assert tuple(int(v) for v in re.findall(r"X\((\d+)\)", box)) == admm_fused.K2_RPT_N
    assert tuple(int(v) for v in re.findall(r"X\(N, (\d+)\)", tail)) == admm_fused.K2_RPT_T


def test_k1_entry_takes_the_plan():
    """admm_diag_chunk's int parameters are the ones the wrapper passes,
    in its order (admm_fused.K1_INTS: the shape, then k1_plan's layout)."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    params = _c_params("admm_diag_chunk")
    sig = _build.SIGNATURES["admm_diag_chunk"]
    ints = [p for p, kind in zip(params, sig) if kind == "i"]
    assert tuple(ints) == admm_fused.K1_INTS
    assert sig == "p" * 17 + "i" * len(admm_fused.K1_INTS) + "ff" + "p"


def test_k1_instantiations_match_the_plan():
    """The rows per thread K1 instantiates (MPC_K1_INSTANCES in
    csrc/admm_diag.cu) are the ones k1_plan may pick, with the same most
    threads a block, and the registers the plan counts, without and with
    refinement, fit the budgets that __launch_bounds__ holds each
    instantiation to."""
    from automationlabsmodelpredictivecontrol_jl_torch.ops import admm_fused

    text = open(os.path.join(_build.CSRC_DIR, "admm_diag.cu")).read()
    body = re.search(r"#define MPC_K1_INSTANCES\(X\)((?:.*\\\n)*.*)", text).group(1)
    rows = [tuple(int(v) for v in m)
            for m in re.findall(r"X\((\d+), (\d+), (\d+), (\d+)\)", body)]
    assert [row[0] for row in rows] == sorted(admm_fused.K1_INSTANCES)
    for rpt, threads, *budgets in rows:
        planned_threads, *registers = admm_fused.K1_INSTANCES[rpt]
        assert planned_threads == threads
        for used, budget in zip(registers, budgets):
            assert used <= budget <= 255 and 65536 // (threads * budget) >= 1
