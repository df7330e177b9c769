"""Percentiles and spreads, frozen for the benchmark."""

from __future__ import annotations

import statistics
from typing import Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile with linear interpolation between order
    statistics (numpy's default, as the port's ``utils/profiling`` takes
    it)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles, as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, q2, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / q2
