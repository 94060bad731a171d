"""Connectors — observation preprocessing between env and module.

Reference: rllib/connectors/ (agent connector pipelines) + utils/filter.py
(MeanStdFilter with distributed stat sync). The high-value member is running
mean-std observation normalization: each runner updates local Welford stats
while sampling, the algorithm merges per-runner deltas into a global stat at
weight-sync time and broadcasts it back, so every runner (and the serving
path) normalizes identically.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


class RunningStat:
    """Parallel-mergeable Welford accumulator over feature vectors."""

    def __init__(self, shape: Sequence[int] = ()):
        self.shape = tuple(shape)
        self.count = 0.0
        self.mean = np.zeros(self.shape, np.float64)
        self.m2 = np.zeros(self.shape, np.float64)

    def push_batch(self, x: np.ndarray) -> None:
        x = np.asarray(x, np.float64).reshape((-1,) + self.shape)
        n_b = x.shape[0]
        if n_b == 0:
            return
        mean_b = x.mean(axis=0)
        m2_b = ((x - mean_b) ** 2).sum(axis=0)
        self._merge(n_b, mean_b, m2_b)

    def _merge(self, n_b: float, mean_b, m2_b) -> None:
        n_a = self.count
        n = n_a + n_b
        delta = mean_b - self.mean
        self.mean = self.mean + delta * (n_b / n)
        self.m2 = self.m2 + m2_b + delta**2 * (n_a * n_b / n)
        self.count = n

    def merge(self, other: "RunningStat") -> None:
        if other.count > 0:
            self._merge(other.count, other.mean, other.m2)

    @property
    def std(self) -> np.ndarray:
        if self.count < 2:
            return np.ones(self.shape, np.float64)
        return np.sqrt(np.maximum(self.m2 / (self.count - 1), 1e-8))

    def copy(self) -> "RunningStat":
        out = RunningStat(self.shape)
        out.count, out.mean, out.m2 = self.count, self.mean.copy(), self.m2.copy()
        return out

    def to_state(self) -> dict:
        return {"count": self.count, "mean": self.mean, "m2": self.m2,
                "shape": self.shape}

    @classmethod
    def from_state(cls, state: dict) -> "RunningStat":
        out = cls(state["shape"])
        out.count = state["count"]
        out.mean = np.asarray(state["mean"], np.float64)
        out.m2 = np.asarray(state["m2"], np.float64)
        return out


class MeanStdFilter:
    """Normalizes observations to ~N(0,1) with running stats.

    Tracks a `delta` accumulator of everything pushed since the last flush,
    so the driver can merge per-runner deltas into the authoritative global
    stat without double counting (reference: utils/filter.py apply_changes)."""

    def __init__(self, shape: Sequence[int]):
        self.stat = RunningStat(shape)
        self.delta = RunningStat(shape)

    def __call__(self, x: np.ndarray, update: bool = True) -> np.ndarray:
        if update:
            self.stat.push_batch(x)
            self.delta.push_batch(x)
        return ((np.asarray(x, np.float64) - self.stat.mean) / self.stat.std).astype(
            np.float32
        )

    def flush_delta(self) -> dict:
        delta = self.delta
        self.delta = RunningStat(self.stat.shape)
        return delta.to_state()

    def set_global(self, state: dict) -> None:
        self.stat = RunningStat.from_state(state)

    def get_state(self) -> dict:
        return self.stat.to_state()


def make_observation_filter(name: Optional[str], obs_shape) -> Optional[MeanStdFilter]:
    if not name or name == "NoFilter":
        return None
    if name == "MeanStdFilter":
        return MeanStdFilter(tuple(obs_shape))
    raise ValueError(f"Unknown observation filter {name!r}")


__all__ = ["MeanStdFilter", "RunningStat", "make_observation_filter"]
