"""Profiling helpers: a trace around a block and latency statistics."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str], *, host: bool = True):
    """``torch.profiler`` around a block, written into ``log_dir`` as a
    Chrome/Perfetto trace (``trace.json``; open it in ui.perfetto.dev;
    ``None`` writes no file). Traces the host's operators (``host=False``
    leaves them out: a solve's 10^5 small operators take minutes to
    collect), and the card's kernels and copies where PyTorch sees a card.
    Yields the profiler, whose ``events()`` and ``key_averages()`` read the
    trace.

    Usage::
        with profiling.trace("mpc-trace"):
            controller, sol = step(controller, x0)
    """
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = ([ProfilerActivity.CPU] if host else []) + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _synchronize(result: Any) -> None:
    """Wait for the devices of every tensor in ``result`` (nested tuples,
    lists, dicts and dataclass records)."""
    seen = set()

    def walk(v):
        if isinstance(v, torch.Tensor):
            if v.device.type == "cuda" and v.device not in seen:
                seen.add(v.device)
                torch.cuda.synchronize(v.device)
        elif isinstance(v, (tuple, list)):
            for x in v:
                walk(x)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif hasattr(v, "__dataclass_fields__"):
            for name in v.__dataclass_fields__:
                walk(getattr(v, name))

    walk(result)


def latencies_ms(fn: Callable[[], Any], *, warmup: int = 2, reps: int = 20) -> np.ndarray:
    """Milliseconds of ``reps`` calls of a thunk on the host clock after
    ``warmup`` untimed ones, each call ending when the devices of every
    tensor in its result are done (where the JAX package blocks until
    ready)."""
    for _ in range(warmup):
        _synchronize(fn())
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _synchronize(fn())
        lat.append((time.perf_counter() - t0) * 1e3)
    return np.asarray(lat)


def benchmark(fn: Callable[[], Any], *, warmup: int = 2, reps: int = 20) -> Dict[str, float]:
    """Latency statistics of a thunk (:func:`latencies_ms`): p50/p90/p99/mean
    in milliseconds and the number of timed calls."""
    a = latencies_ms(fn, warmup=warmup, reps=reps)
    return {
        "p50_ms": float(np.percentile(a, 50)),
        "p90_ms": float(np.percentile(a, 90)),
        "p99_ms": float(np.percentile(a, 99)),
        "mean_ms": float(a.mean()),
        "reps": float(reps),
    }


def solve_rate(batch: int, stats: Dict[str, float]) -> float:
    """Solves/s implied by a batched-solve latency measurement."""
    return batch / (stats["mean_ms"] / 1e3)
