"""Top-K checkpoint bookkeeping (reference: air/_internal/checkpoint_manager.py
driven by CheckpointConfig air/config.py:574)."""

from __future__ import annotations

import heapq
import itertools
import time
from typing import Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import CheckpointConfig


class CheckpointManager:
    def __init__(self, config: CheckpointConfig):
        self._config = config
        self._heap: list = []  # (sort_score, counter, checkpoint, metrics)
        self._counter = itertools.count()
        self.latest: Optional[Checkpoint] = None
        self.latest_metrics: dict = {}
        # Driver-side checkpoint-phase accounting for the train profiler:
        # registration is cheap for dict checkpoints but can spill/copy for
        # directory ones, and that time belongs to the round that paid it.
        self.last_register_s: float = 0.0
        self.register_time_s: float = 0.0
        self.registrations: int = 0

    def register(self, checkpoint: Checkpoint, metrics: dict) -> None:
        t0 = time.perf_counter()
        self._register(checkpoint, metrics)
        self.last_register_s = time.perf_counter() - t0
        self.register_time_s += self.last_register_s
        self.registrations += 1

    def _register(self, checkpoint: Checkpoint, metrics: dict) -> None:
        self.latest = checkpoint
        self.latest_metrics = dict(metrics)
        attr = self._config.checkpoint_score_attribute
        if attr is not None and attr in metrics:
            score = float(metrics[attr])
        else:
            # No score attribute: recency-ordered.
            score = float(next(self._counter))
        # Min-heap keeps the WORST at the root for eviction.
        sort_score = score if self._config.checkpoint_score_order == "max" else -score
        heapq.heappush(
            self._heap, (sort_score, next(self._counter), checkpoint, dict(metrics))
        )
        keep = self._config.num_to_keep
        if keep is not None:
            while len(self._heap) > keep:
                heapq.heappop(self._heap)

    @property
    def best(self) -> Optional[Checkpoint]:
        if not self._heap:
            return self.latest
        return max(self._heap, key=lambda e: (e[0], e[1]))[2]

    @property
    def best_metrics(self) -> dict:
        if not self._heap:
            return self.latest_metrics
        return max(self._heap, key=lambda e: (e[0], e[1]))[3]

    def all_checkpoints(self) -> list[Checkpoint]:
        return [e[2] for e in sorted(self._heap, key=lambda e: e[1])]
