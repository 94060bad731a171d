"""Tuner: the modern Tune entry point.

Reference: tune/tuner.py:320 Tuner.fit → impl/tuner_internal.py:583 →
tune/tune.py:293 run. `Tuner(trainable, param_space=..., tune_config=...,
run_config=...)` — trainable may be a function(config), a Trainable subclass,
or a ray_tpu_torch Trainer instance (wrapped into a 1-trial run the way
base_trainer.py:559 does).
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Any, Callable, Optional

from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.tune.execution.tune_controller import TuneController
from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.tune.schedulers import TrialScheduler
from ray_tpu_torch.tune.search.searcher import Searcher
from ray_tpu_torch.tune.trainable import Trainable, wrap_function


@dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    search_alg: Optional[Searcher] = None
    scheduler: Optional[TrialScheduler] = None
    reuse_actors: bool = False
    seed: Optional[int] = None


def _as_trainable_cls(trainable: Any) -> type:
    if isinstance(trainable, type) and issubclass(trainable, Trainable):
        return trainable
    if callable(trainable) and not isinstance(trainable, type):
        # Trainer instances (duck-typed: has .fit and ._as_trainable).
        if hasattr(trainable, "as_trainable"):
            return trainable.as_trainable()
        return wrap_function(trainable)
    if hasattr(trainable, "as_trainable"):
        return trainable.as_trainable()
    raise TypeError(f"Cannot convert {trainable!r} to a Trainable")


class Tuner:
    def __init__(
        self,
        trainable: Any,
        *,
        param_space: Optional[dict] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
        resources_per_trial: Optional[dict] = None,
        _controller_kwargs: Optional[dict] = None,
    ):
        self._trainable = trainable
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config or RunConfig()
        self._resources = resources_per_trial
        self._controller_kwargs = _controller_kwargs or {}
        self._controller: Optional[TuneController] = None
        self._seed_trials: list = []

    def fit(self) -> ResultGrid:
        tc = self._tune_config
        rc = self._run_config
        stop = dict(rc.stop) if getattr(rc, "stop", None) else {}
        exp_dir = ""
        if getattr(rc, "storage_path", None) or getattr(rc, "name", None):
            # resolved_storage_path() already includes the run name.
            exp_dir = rc.resolved_storage_path()
        failure_cfg = getattr(rc, "failure_config", None)
        max_failures = getattr(failure_cfg, "max_failures", 0) if failure_cfg else 0
        ckpt_cfg = getattr(rc, "checkpoint_config", None)
        checkpoint_at_end = (
            getattr(ckpt_cfg, "checkpoint_at_end", True) if ckpt_cfg else True
        )

        checkpoint_frequency = (
            getattr(ckpt_cfg, "checkpoint_frequency", 0) if ckpt_cfg else 0
        )

        self._controller = TuneController(
            _as_trainable_cls(self._trainable),
            param_space=self._param_space,
            searcher=tc.search_alg,
            scheduler=tc.scheduler,
            metric=tc.metric,
            mode=tc.mode,
            num_samples=tc.num_samples,
            stop=stop,
            max_concurrent_trials=tc.max_concurrent_trials,
            resources_per_trial=self._resources,
            max_failures=max_failures,
            checkpoint_at_end=checkpoint_at_end,
            checkpoint_frequency=checkpoint_frequency,
            experiment_dir=exp_dir,
            seed=tc.seed,
            reuse_actors=tc.reuse_actors,
            seed_trials=self._seed_trials,
            **self._controller_kwargs,
        )
        self._save_tuner_state(self._controller._experiment_dir)
        trials = self._controller.run()
        return ResultGrid(trials, tc.metric, tc.mode)

    def _save_tuner_state(self, exp_dir: str) -> None:
        try:
            with open(os.path.join(exp_dir, "tuner.pkl"), "wb") as f:
                pickle.dump(
                    {
                        "param_space": self._param_space,
                        "tune_config": self._tune_config,
                        "run_config": self._run_config,
                        "resources_per_trial": self._resources,
                    },
                    f,
                )
        except Exception:
            pass  # non-picklable search spaces: resume unavailable, fit fine

    @classmethod
    def restore(cls, path: str, trainable: Any) -> "Tuner":
        """Rebuild a Tuner from a saved experiment dir. Unfinished (non-
        TERMINATED) trials are re-seeded and re-run on fit(), resuming from
        their last persisted checkpoint when one exists."""
        import json

        with open(os.path.join(path, "tuner.pkl"), "rb") as f:
            state = pickle.load(f)
        tuner = cls(trainable, **state)
        state_file = os.path.join(path, "experiment_state.json")
        seeds = []
        if os.path.exists(state_file):
            with open(state_file) as f:
                exp = json.load(f)
            for meta in exp.get("trials", []):
                if meta.get("status") == "TERMINATED":
                    continue
                ckpt = None
                ckpt_file = os.path.join(
                    path, f"trial_{meta['trial_id']}", "checkpoint.pkl"
                )
                if os.path.exists(ckpt_file):
                    with open(ckpt_file, "rb") as f:
                        ckpt = pickle.load(f)
                config = meta.get("config")
                if isinstance(config, dict):
                    seeds.append((config, ckpt))
        tuner._seed_trials = seeds
        # Seeded trials replace fresh sampling: don't re-expand the space.
        if seeds:
            tuner._tune_config.num_samples = 0
            tuner._param_space = {}
        return tuner


def run(
    trainable: Any,
    *,
    config: Optional[dict] = None,
    metric: Optional[str] = None,
    mode: str = "max",
    num_samples: int = 1,
    stop: Optional[dict] = None,
    search_alg: Optional[Searcher] = None,
    scheduler: Optional[TrialScheduler] = None,
    resources_per_trial: Optional[dict] = None,
    max_concurrent_trials: Optional[int] = None,
    **kwargs,
) -> ResultGrid:
    """Legacy tune.run surface (reference: tune/tune.py:293)."""
    controller = TuneController(
        _as_trainable_cls(trainable),
        param_space=config or {},
        searcher=search_alg,
        scheduler=scheduler,
        metric=metric,
        mode=mode,
        num_samples=num_samples,
        stop=stop,
        resources_per_trial=resources_per_trial,
        max_concurrent_trials=max_concurrent_trials,
        **kwargs,
    )
    trials = controller.run()
    return ResultGrid(trials, metric, mode)
