"""The PyTorch port imports without JAX: the machine that runs it on the
GPU has no jax, and the JAX package changes a global setting on import."""

import subprocess
import sys

import jax  # noqa: F401  (both frameworks load in the test process)
import torch

torch.set_num_threads(1)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import automationlabsmodelpredictivecontrol_jl_torch as m\n"
        "from automationlabsmodelpredictivecontrol_jl_torch import interop, parallel\n"
        "from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import qtp\n"
        "from automationlabsmodelpredictivecontrol_jl_torch.ops import _build, admm_fused, condense\n"
        "from automationlabsmodelpredictivecontrol_jl_torch import terminal\n"
        "from automationlabsmodelpredictivecontrol_jl_torch.utils import devices, profiling, roofline\n"
        "from automationlabsmodelpredictivecontrol_jl_torch import io, systems\n"
        "from automationlabsmodelpredictivecontrol_jl_torch.models import activations, zoo\n"
        "from automationlabsmodelpredictivecontrol_jl_torch.solvers import empc, milp, sqp\n"
        "from automationlabsmodelpredictivecontrol_jl_torch import native_qp\n"
        "from automationlabsmodelpredictivecontrol_jl_torch.ops import dare, riccati_ltv\n"
        "from automationlabsmodelpredictivecontrol_jl_torch.benchmarks import big, training, unstable\n"
        "assert callable(sqp.solve_nonlinear_ms) and callable(io.load_controller)\n"
        "assert callable(empc.solve_economic) and callable(milp.solve_milp_batch)\n"
        "assert callable(native_qp.solve_relu_bb) and callable(m.takagi_sugeno_system)\n"
        "assert callable(admm_fused.iterate_chunk_mixed_T) and callable(terminal.invariant_terminal_set)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k.startswith('automationlabsmodelpredictivecontrol_jl_tpu'))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_card(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line when there is
    no card, and also when it stands alone outside the repository."""
    import os
    import shutil

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(root, "chip_smoke.py"), alone)
    for cwd, script in ((root, "chip_smoke.py"), (tmp_path, str(alone))):
        res = subprocess.run(
            [sys.executable, script], cwd=cwd, capture_output=True, text=True,
            timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
        )
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
