"""No module of JAX or the JAX package in a run, compared by whole
top-level names."""

import ast
import os
import sys

from mpcbench import harness
from mpcbench.tests import tiny


def test_top_level_names_compared_whole():
    assert harness.forbidden_modules(["automationlabsmodelpredictivecontrol_jl_torch.ops",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen",
                                      "automationlabsmodelpredictivecontrol_jl_tpu.ops.admm"]) \
        == ["automationlabsmodelpredictivecontrol_jl_tpu", "flax", "jax", "jaxlib"]


def test_no_source_of_the_benchmark_imports_them():
    for dirpath, _, files in os.walk(harness.HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                assert not harness.forbidden_modules(names), (f, names)


def test_a_run_with_jax_loaded_prints_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", sys.modules["os"])
    code, line, err = tiny.run("qtp-h500-riccati.fleet-B1024")
    assert code != 0 and line is None and "jax" in err
