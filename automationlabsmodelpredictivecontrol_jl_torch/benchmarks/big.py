"""Synthetic wider plants: the framework beyond the 4-state QTP."""

from __future__ import annotations

import numpy as np

from ..systems import LinearDiscreteSystem
from ..types import Box, f32


def random_stable_system(
    nx: int = 16,
    nu: int = 8,
    seed: int = 0,
    spectral_radius: float = 0.95,
) -> LinearDiscreteSystem:
    """A random discrete LTI plant scaled to the given spectral radius, with
    unit state boxes and +-2 input boxes; the JAX package's
    ``benchmarks/big.py`` (numpy, the same numbers for the same seed)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((nx, nx)).astype(np.float64) / np.sqrt(nx)
    eig = np.max(np.abs(np.linalg.eigvals(A)))
    A = A * (spectral_radius / max(eig, 1e-9))
    B = rng.standard_normal((nx, nu)).astype(np.float64) / np.sqrt(nx)
    return LinearDiscreteSystem(
        A=f32(np.asarray(A, np.float32)),
        B=f32(np.asarray(B, np.float32)),
        X=Box(lo=f32(np.full(nx, -1.0)), hi=f32(np.full(nx, 1.0))),
        U=Box(lo=f32(np.full(nu, -2.0)), hi=f32(np.full(nu, 2.0))),
    )
