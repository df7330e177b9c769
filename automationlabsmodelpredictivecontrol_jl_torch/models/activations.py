"""Activation registry for the learned-dynamics model zoo.

The JAX package's ``models/activations.py``: each name maps to the
PyTorch function with the same values, so a network carried across with
its weights evaluates the same map. ``gelu`` is the tanh approximation
(``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gaussian_rbf(x: torch.Tensor) -> torch.Tensor:
    """Radial-basis activation exp(-x^2) (the rbf family)."""
    return torch.exp(-torch.square(x))


ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "swish": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "softplus": F.softplus,
    "gaussian": gaussian_rbf,
    "identity": lambda x: x,
}


def get_activation(name):
    """The activation called ``name``; a callable passes through."""
    if callable(name):
        return name
    try:
        return ACTIVATIONS[name]
    except KeyError as e:
        raise ValueError(
            f"unknown activation {name!r}; available: {sorted(ACTIVATIONS)}"
        ) from e
