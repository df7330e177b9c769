"""Device helpers.

Controller design runs on the host in numpy f64; the finished operator is
moved to the device the caller names, the card by default. Solves run on
the device of their input tensors. There is deliberately no helper that
falls back to the CPU when no card is present: a path that needs the card
says so, and the CPU is used only where the caller names it.
"""

from __future__ import annotations

from typing import Any

import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises when PyTorch sees no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is False (this path "
            "runs only on an NVIDIA GPU)"
        )
    return torch.device("cuda", 0)


def resolve_device(device: Any = None) -> torch.device:
    """``device`` as a torch.device; ``None`` is the card
    (:func:`require_cuda`)."""
    return require_cuda() if device is None else torch.device(device)
