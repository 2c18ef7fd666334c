"""Online/streaming local data (paper §5.3).

Each client starts with a random fraction of its training split and the
visible window grows by ``growth`` (0.05%-0.1% of the full size) every
global iteration — "data continues arriving during the global iterations".
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class OnlineStream:
    x: np.ndarray  # (n, ...) full local training data
    y: np.ndarray
    start_frac: float = 0.3
    growth: float = 0.00075  # fraction of n revealed per iteration
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.n = len(self.x)
        self._start = max(1, int(self.start_frac * self.n))

    def visible(self, t: int) -> int:
        """Number of samples available at global iteration t."""
        return min(self.n, self._start + int(self.growth * self.n * t))

    def batch(self, t: int, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        v = self.visible(t)
        if v <= 0:  # empty visible window (e.g. an empty local split at t=0):
            # return size-0 arrays without consuming rng draws; callers pad
            return self.x[:0], self.y[:0]
        idx = self._rng.integers(0, v, size=min(batch_size, v))
        return self.x[idx], self.y[idx]

    def batch_into(self, t: int, out_x: np.ndarray, out_y: np.ndarray) -> None:
        """Draw one ``len(out_x)``-row minibatch directly into staging rows.

        Consumes exactly the rng draws of :meth:`batch` (the prefetch
        determinism contract), then pads a short draw by cycling the drawn
        rows — the resampling semantics of ``pad_batch`` — and an empty
        visible window with zeros, all without allocating fresh arrays.
        """
        B = len(out_x)
        v = self.visible(t)
        if v <= 0:
            out_x[:] = 0
            out_y[:] = 0
            return
        idx = self._rng.integers(0, v, size=min(B, v))
        m = len(idx)
        np.take(self.x, idx, axis=0, out=out_x[:m])
        np.take(self.y, idx, axis=0, out=out_y[:m])
        if m < B:  # cycle the drawn rows (== np.resize row semantics)
            wrap = np.arange(m, B) % m
            out_x[m:] = out_x[wrap]
            out_y[m:] = out_y[wrap]

    def window(self, t: int) -> Tuple[np.ndarray, np.ndarray]:
        v = self.visible(t)
        return self.x[:v], self.y[:v]

    def rng_state(self) -> dict:
        """JSON-able snapshot of the batch-draw rng (crash-resume hook)."""
        return self._rng.bit_generator.state

    def set_rng_state(self, state: dict) -> None:
        self._rng.bit_generator.state = state
