"""BackendExecutor — drives the worker group through a training run.

Reference: train/_internal/backend_executor.py:45 (placement group :164,
start_training :342, _restart :625). Orchestration only — runs no math.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import ray_tpu_torch
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import ScalingConfig
from ray_tpu_torch.train.backend import Backend, BackendConfig
from ray_tpu_torch.train.worker_group import WorkerGroup

logger = logging.getLogger(__name__)


class TrainingWorkerError(RuntimeError):
    pass


class BackendExecutor:
    def __init__(
        self,
        backend_config: BackendConfig,
        scaling_config: ScalingConfig,
    ):
        self._backend_config = backend_config
        self._backend: Backend = backend_config.backend_cls()
        self._scaling = scaling_config
        self.worker_group: Optional[WorkerGroup] = None

    def start(self) -> None:
        try:
            self.worker_group = WorkerGroup(
                num_workers=self._scaling.num_workers,
                bundle_specs=self._scaling.bundle_specs(),
                strategy=self._scaling.strategy(),
            )
            self._backend.on_start(self.worker_group, self._backend_config)
        except Exception as exc:
            # A worker dying while the group forms (e.g. its node was killed
            # between scheduling and startup) is a recoverable group failure:
            # the trainer's FailureConfig loop re-forms on surviving nodes.
            # Tear down whatever partially formed so the retry doesn't leak
            # actors (and the resources they hold).
            self.shutdown()
            raise TrainingWorkerError(f"worker group failed to start: {exc}") from exc

    def start_training(
        self,
        train_fn: Callable,
        config: dict,
        checkpoint: Optional[Checkpoint],
        dataset_shard_fn: Optional[Callable[[int, int], Optional[dict]]] = None,
        observability: Optional[dict] = None,
    ) -> None:
        assert self.worker_group is not None
        self._backend.on_training_start(self.worker_group, self._backend_config)
        refs = []
        for rank, worker in enumerate(self.worker_group.workers):
            shards = (
                dataset_shard_fn(rank, self._scaling.num_workers)
                if dataset_shard_fn
                else None
            )
            refs.append(
                worker.start_training.remote(
                    train_fn, config, checkpoint, shards, observability
                )
            )
        try:
            ray_tpu_torch.get(refs, timeout=300.0)
        except Exception as exc:
            raise TrainingWorkerError(f"training failed to launch: {exc}") from exc

    def next_results(self) -> Optional[list[dict]]:
        """One rendezvous round: every worker's next report, or None when all
        finished. Raises TrainingWorkerError wrapping the first worker error."""
        assert self.worker_group is not None
        refs = [w.next_result.remote() for w in self.worker_group.workers]
        try:
            results = ray_tpu_torch.get(refs, timeout=None)
        except Exception as exc:
            raise TrainingWorkerError(str(exc)) from exc
        finished = [r is None for r in results]
        if all(finished):
            return None
        if any(finished):
            raise TrainingWorkerError(
                "Workers finished unevenly — mismatched session.report calls"
            )
        return results

    def profile_records(self) -> list:
        """Per-rank profiler rings from the live worker group (empty when
        no group is up or instrumentation is off)."""
        if self.worker_group is None:
            return []
        return self.worker_group.profile_records()

    def restart(self) -> None:
        """Tear down and re-form the worker group (reference _restart :625).
        Restart is always whole-group, as in the reference."""
        self.shutdown()
        self.start()

    def shutdown(self) -> None:
        if self.worker_group is not None:
            try:
                self._backend.on_shutdown(self.worker_group, self._backend_config)
            except Exception:
                pass
            self.worker_group.shutdown()
            self.worker_group = None
