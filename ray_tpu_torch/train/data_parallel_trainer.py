"""DataParallelTrainer — the Trainer surface.

Reference: train/data_parallel_trainer.py:58,422 + train/trainer.py:41
(TrainingIterator) + base_trainer.py:559 (fit). Differences by design: the
trainer runs standalone (the reference wraps every fit in a 1-trial Tune run).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import FailureConfig, RunConfig, ScalingConfig, TrainConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train.backend_executor import BackendExecutor, TrainingWorkerError
from ray_tpu_torch.train.checkpoint_manager import CheckpointManager


class DataParallelTrainer:
    _default_backend_config: BackendConfig = BackendConfig()

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[dict] = None,
        backend_config: Optional[BackendConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        train_config: Optional[TrainConfig] = None,
        datasets: Optional[dict] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self._train_fn = train_loop_per_worker
        self._train_config = dict(train_loop_config or {})
        self._backend_config = backend_config or self._default_backend_config
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.train_config = train_config or TrainConfig()
        self._datasets = dict(datasets or {})
        for name, ds in self._datasets.items():
            if hasattr(ds, "streaming_split") or hasattr(ds, "iter_batches"):
                raise NotImplementedError(
                    f"datasets[{name!r}]: Dataset shards (ray_tpu.data) are "
                    "not ported (ROADMAP.md §B9); pass a list"
                )
        self._resume_checkpoint = resume_from_checkpoint
        # Live executor while fit() runs — the mid-fit liveness surface.
        self._executor: Optional[BackendExecutor] = None

    def profile_records(self) -> list:
        """Per-rank profiler rings straight from the live worker group —
        mid-fit liveness (e.g. from another thread,
        without waiting for Result.train_report). [] before fit(), after
        shutdown, or when instrumentation is off."""
        executor = self._executor
        if executor is None:
            return []
        return executor.profile_records()

    def as_trainable(self) -> type:
        """Tune over the trainer is not ported (the reference wraps fit()
        as a Tune trial here)."""
        raise NotImplementedError(
            "DataParallelTrainer.as_trainable: Tune over the trainer is not "
            "ported (ROADMAP.md §B4)"
        )

    # -- dataset sharding ----------------------------------------------------

    def _dataset_shard_fn(self, rank: int, world_size: int) -> Optional[dict]:
        """Plain-list shards: rank r gets items r, r + world_size, ...; any
        other value goes to every rank as it is."""
        if not self._datasets:
            return None
        return {
            name: ds[rank::world_size] if isinstance(ds, (list, tuple)) else ds
            for name, ds in self._datasets.items()
        }

    # -- fit -----------------------------------------------------------------

    def fit(self) -> Result:
        failure_config = self.run_config.failure_config or FailureConfig()
        max_failures = failure_config.max_failures
        ckpt_manager = CheckpointManager(self.run_config.checkpoint_config)
        executor = BackendExecutor(self._backend_config, self.scaling_config)
        self._executor = executor
        history: list[dict] = []
        error: Optional[BaseException] = None
        failures = 0
        start = time.monotonic()
        run = None
        if self.train_config.instrument:
            from ray_tpu_torch.train.observability import TrainRunRecord, register_run

            run = register_run(
                TrainRunRecord(
                    name=self.run_config.name or type(self).__name__,
                    trainer=type(self).__name__,
                    num_workers=self.scaling_config.num_workers,
                    straggler_factor=self.train_config.straggler_factor,
                    straggler_min_s=self.train_config.straggler_min_s,
                    rounds_capacity=self.train_config.rounds_capacity,
                )
            )

        try:
            while True:
                try:
                    # Whole-group (re-)form — restart() is shutdown+start,
                    # idempotent when nothing is up yet. Inside the try so a death DURING
                    # the re-form (e.g. placement raced node-failure
                    # detection) counts as another recoverable failure.
                    executor.restart()
                    self._run_training(executor, ckpt_manager, history, run)
                    break
                except TrainingWorkerError as exc:
                    failures += 1
                    if max_failures != -1 and failures > max_failures:
                        error = exc
                        break
                    # Resume the next attempt from the latest checkpoint.
                    self._resume_checkpoint = ckpt_manager.latest or self._resume_checkpoint
        except BaseException as exc:
            # Anything outside the worker-retry path (group-form timeout,
            # KeyboardInterrupt, ...) propagates — but the run record must
            # not report a crashed fit as ok.
            error = exc
            raise
        finally:
            executor.shutdown()
            if run is not None:
                # Closes the `train.fit` root span every round span chains
                # to — one fit(), one connected trace.
                run.finish(error)

        metrics = dict(ckpt_manager.latest_metrics or (history[-1] if history else {}))
        metrics.setdefault("time_total_s", time.monotonic() - start)
        metrics["training_iteration"] = len(history)
        return Result(
            metrics=metrics,
            checkpoint=ckpt_manager.best,
            error=error,
            path=self.run_config.resolved_storage_path(),
            metrics_history=history,
            train_report=run.report() if run is not None else None,
        )

    def _run_training(
        self,
        executor: BackendExecutor,
        ckpt_manager: CheckpointManager,
        history: list[dict],
        run=None,
    ) -> None:
        observability = None
        if run is not None:
            observability = {
                "trace": (run.trace_id, run.fit_span_id),
                # Continue the driver's round numbering across failure
                # restarts so retried rounds reuse their span ids (a retry
                # is the same logical round re-executed).
                "round_offset": len(history),
                "capacity": self.train_config.profiler_capacity,
            }
        executor.start_training(
            self._train_fn,
            self._train_config,
            self._resume_checkpoint,
            self._dataset_shard_fn,
            observability=observability,
        )
        while True:
            round_start = time.time()
            results = executor.next_results()
            if results is None:
                return
            profiles = [r.pop("profile", None) for r in results]
            rank0 = results[0]
            metrics = rank0["metrics"]
            # Rank 0's checkpoint is authoritative (reference: master-rank
            # persistence, train/_internal/checkpoint.py:35).
            checkpoint = rank0.get("checkpoint")
            if checkpoint is not None:
                ckpt_manager.register(checkpoint, metrics)
            else:
                ckpt_manager.latest_metrics = dict(metrics)
            round_idx = len(history)
            history.append(dict(metrics))
            if run is not None:
                run.record_round(
                    round_idx,
                    profiles,
                    round_start,
                    time.time(),
                    checkpoint_s=(
                        ckpt_manager.last_register_s if checkpoint is not None else 0.0
                    ),
                )
