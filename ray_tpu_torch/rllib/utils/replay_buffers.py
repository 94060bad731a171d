"""Replay buffers — uniform ring + proportional prioritized.

Reference: rllib/utils/replay_buffers/replay_buffer.py (ReplayBuffer,
storage_unit=timesteps) and prioritized_replay_buffer.py (proportional
prioritization per Schaul et al.; the reference uses a segment tree — numpy
cumulative sums are equivalent at the sizes that fit one host and keep the
sampling path vectorized).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


class ReplayBuffer:
    """Uniform-sampling ring buffer over timestep rows."""

    def __init__(self, capacity: int = 100_000, seed: Optional[int] = None):
        self.capacity = int(capacity)
        self._columns: dict[str, np.ndarray] = {}
        self._size = 0
        self._next = 0
        self._rng = np.random.default_rng(seed)
        self._num_added = 0

    def __len__(self) -> int:
        return self._size

    def add(self, batch: SampleBatch) -> None:
        n = batch.count
        if n == 0:
            return
        self._num_added += n
        for k, v in batch.items():
            if k == SampleBatch.INFOS:
                continue
            v = np.asarray(v)
            if k not in self._columns:
                self._columns[k] = np.zeros(
                    (self.capacity,) + v.shape[1:], dtype=v.dtype
                )
            col = self._columns[k]
            idx = (self._next + np.arange(n)) % self.capacity
            col[idx] = v
        self._next = (self._next + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def sample(self, num_items: int) -> SampleBatch:
        assert self._size > 0, "buffer empty"
        idx = self._rng.integers(0, self._size, size=num_items)
        return self._take(idx)

    def _take(self, idx: np.ndarray) -> SampleBatch:
        return SampleBatch({k: v[idx] for k, v in self._columns.items()})

    def stats(self) -> dict:
        return {"size": self._size, "num_added": self._num_added}


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized sampling with importance weights."""

    def __init__(
        self,
        capacity: int = 100_000,
        alpha: float = 0.6,
        beta: float = 0.4,
        seed: Optional[int] = None,
    ):
        super().__init__(capacity, seed)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self._priorities = np.zeros(self.capacity, dtype=np.float64)
        self._max_priority = 1.0

    def add(self, batch: SampleBatch) -> None:
        n = batch.count
        idx = (self._next + np.arange(n)) % self.capacity
        super().add(batch)
        self._priorities[idx] = self._max_priority**self.alpha

    def sample(self, num_items: int, beta: Optional[float] = None) -> SampleBatch:
        assert self._size > 0, "buffer empty"
        beta = self.beta if beta is None else beta
        p = self._priorities[: self._size]
        probs = p / p.sum()
        idx = self._rng.choice(self._size, size=num_items, p=probs)
        batch = self._take(idx)
        weights = (self._size * probs[idx]) ** (-beta)
        batch["weights"] = (weights / weights.max()).astype(np.float32)
        batch["batch_indexes"] = idx.astype(np.int64)
        return batch

    def update_priorities(self, idx: np.ndarray, priorities: np.ndarray) -> None:
        priorities = np.abs(np.asarray(priorities, dtype=np.float64)) + 1e-6
        self._priorities[idx] = priorities**self.alpha
        self._max_priority = max(self._max_priority, float(priorities.max()))
