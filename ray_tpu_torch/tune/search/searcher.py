"""Searcher protocol (reference: tune/search/searcher.py Searcher ABC,
tune/search/basic_variant.py BasicVariantGenerator,
tune/search/concurrency_limiter.py).

A Searcher suggests configs and learns from completed-trial results; the
grid/random default just walks the variant generator. Bayesian-style adapters
(Optuna/HyperOpt/...) plug in by subclassing `Searcher` — the controller only
sees suggest/on_trial_complete.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional

from ray_tpu_torch.tune.search.sample import Domain
from ray_tpu_torch.tune.search.variant_generator import generate_variants


class Searcher:
    """Suggest-based search algorithm interface."""

    FINISHED = "FINISHED"

    def __init__(self, metric: Optional[str] = None, mode: Optional[str] = None):
        self.metric = metric
        self.mode = mode

    def set_search_properties(
        self, metric: Optional[str], mode: Optional[str], config: dict
    ) -> bool:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    def suggest(self, trial_id: str) -> Optional[dict]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        pass

    def on_trial_complete(
        self, trial_id: str, result: Optional[dict] = None, error: bool = False
    ) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Grid + random search over the param_space (the default searcher)."""

    def __init__(
        self,
        space: Optional[dict] = None,
        num_samples: int = 1,
        seed: Optional[int] = None,
        max_concurrent: int = 0,
    ):
        super().__init__()
        self._space = space or {}
        self._num_samples = num_samples
        self._seed = seed
        self._iter = None
        self.max_concurrent = max_concurrent

    def set_search_properties(self, metric, mode, config) -> bool:
        super().set_search_properties(metric, mode, config)
        if config:
            self._space = config
        return True

    def suggest(self, trial_id: str) -> Optional[dict]:
        if self._iter is None:
            self._iter = generate_variants(
                self._space, self._num_samples, self._seed
            )
        try:
            return next(self._iter)
        except StopIteration:
            return None

    @property
    def total_samples(self) -> int:
        from ray_tpu_torch.tune.search.variant_generator import count_variants

        return count_variants(self._space, self._num_samples)


class RandomSearch(Searcher):
    """Pure random sampling forever (bounded by num_samples at the Tuner)."""

    def __init__(self, space: dict, seed: Optional[int] = None):
        super().__init__()
        self._space = space
        self._rng = random.Random(seed)

    def suggest(self, trial_id: str) -> Optional[dict]:
        return next(generate_variants(self._space, 1, self._rng.random()))


class ConcurrencyLimiter(Searcher):
    """Cap in-flight suggestions from a wrapped searcher."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def set_search_properties(self, metric, mode, config) -> bool:
        return self.searcher.set_search_properties(metric, mode, config)

    def is_saturated(self) -> bool:
        return len(self._live) >= self.max_concurrent

    def suggest(self, trial_id: str) -> Optional[dict]:
        if self.is_saturated():
            return None  # backpressure: controller checks is_saturated()
        config = self.searcher.suggest(trial_id)
        if config is not None:
            self._live.add(trial_id)
        return config

    def on_trial_result(self, trial_id, result):
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)
