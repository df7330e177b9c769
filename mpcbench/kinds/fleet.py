"""The ``fleet`` kind: back-to-back batches of ``lanes`` scenarios, a closed
loop of one client (the next batch goes when the last one's results are on
the host), every batch solved cold.

Each scenario is an initial state clip(x0_mean + x0_std N(0, 1), x0_lo,
x0_hi), drawn in float32 on the card by a ``torch.Generator`` seeded with
the run's seed, batch after batch. ``ranks`` > 1 splits each batch over that
many processes, one a card, each drawing the whole batch and solving its
rows. A run compares ``sample_lanes`` lanes of every batch, drawn from the
seed, and the batch's slowest lane. Set-up solves ``warmup_batches``
batches of the same shape.
"""

from __future__ import annotations

import numpy as np
import torch

from mpcbench import harness

KEYS = ("x0_mean", "x0_std", "x0_lo", "x0_hi", "warmup_batches", "sample_lanes")


def check(mix, name) -> None:
    if not mix["x0_lo"] <= mix["x0_mean"] <= mix["x0_hi"] or mix["x0_std"] < 0:
        raise ValueError(f"traffic {name!r}: x0_mean outside [x0_lo, x0_hi], or x0_std < 0")


class Source:
    """Batches of initial states (lanes, nx) on ``device`` from ``seed``:
    the same seed gives the same batches in the same order, on any card."""

    def __init__(self, mix, seed: int, nx: int, device):
        self.mix, self.nx, self.device = mix, nx, torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed) % 2 ** 63)
        self.seed = int(seed)

    def next(self) -> torch.Tensor:
        m = self.mix
        z = torch.randn((m["lanes"], self.nx), generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return torch.clamp(m["x0_mean"] + m["x0_std"] * z, m["x0_lo"], m["x0_hi"])

    def sample(self, batch: int, rows: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed % 2 ** 63, batch])
        k = min(int(self.mix["sample_lanes"]), rows)
        return np.sort(rng.choice(rows, size=k, replace=False))


def warm_up(session, source) -> None:
    for _ in range(session.mix["warmup_batches"]):
        session.solve(source.next())


def run_window(session, source, seconds: float, stop=None, keep: bool = True):
    """Batches back to back until ``stop(elapsed)`` (default: the window's
    seconds have passed) after a batch."""
    stop = stop or (lambda elapsed: elapsed >= seconds)
    w = harness.Window(session)
    while True:
        x0s = source.next()
        w.batch(x0s, source, keep)
        if stop(w.seconds):
            return w.close()
