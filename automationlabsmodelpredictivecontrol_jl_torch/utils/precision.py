"""IEEE fp32 matmuls, set and checked.

The solver's convergence certificates sit at 1e-6 and its parity bar at
1e-4. TF32 keeps about three decimal digits, so a float32 product that
silently runs in TF32 perturbs the QP being solved far past both. The
JAX package pins HIGHEST for the same reason, after a bf16 default broke
its certificates on hardware while the CPU suite stayed green.
"""

from __future__ import annotations

import torch


def pin_ieee_fp32() -> None:
    """Make every float32 matmul and convolution run in full IEEE fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def assert_ieee_fp32() -> None:
    """Raise if anything turned TF32 (or bf16) matmuls back on."""
    if (
        torch.backends.cuda.matmul.allow_tf32
        or torch.backends.cudnn.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "float32 matmuls are not IEEE fp32 (TF32 enabled or matmul "
            "precision below 'highest'); call utils.precision.pin_ieee_fp32()"
        )
