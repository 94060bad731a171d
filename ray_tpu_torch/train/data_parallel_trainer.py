"""DataParallelTrainer — the Trainer surface.

Reference: train/data_parallel_trainer.py:58,422 + train/trainer.py:41
(TrainingIterator) + base_trainer.py:559 (fit). Differences by design: the
trainer runs standalone (the reference wraps every fit in a 1-trial Tune run;
here Tune drives trainers through `as_trainable` instead, keeping the fit
path free of tune plumbing).
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
        self._resume_checkpoint = resume_from_checkpoint
        self._latest_checkpoint: Optional[Checkpoint] = None
        self._result_callbacks: list[Callable[[dict], None]] = []
        # Display name for the run registry (Tune sets it to the trial id).
        self._run_name: Optional[str] = None
        # Live executor while fit() runs — the mid-fit liveness surface.
        self._executor: Optional[BackendExecutor] = None

    def profile_records(self) -> list:
        """Per-rank profiler rings straight from the live worker group —
        mid-fit liveness (e.g. from a result callback or another thread,
        without waiting for Result.train_report). [] before fit(), after
        shutdown, or when instrumentation is off."""
        executor = self._executor
        if executor is None:
            return []
        return executor.profile_records()

    def add_result_callback(self, fn: Callable[[dict], None]) -> None:
        """Called with rank-0 metrics after every report round (Tune hook)."""
        self._result_callbacks.append(fn)

    def as_trainable(self) -> type:
        """Wrap this trainer for Tune — every fit() becomes a (potentially
        multi-worker) trial, the reference's BaseTrainer.fit-wraps-a-1-trial-
        Tune-run flow inverted (train/base_trainer.py:559). Trial configs merge
        under the `train_loop_config` key, like the reference. A stopped trial
        (a scheduler's STOP, a PBT exploit) ends its fit at the next round:
        the trial's report raises StopIteration inside the result callback,
        and fit() shuts its worker group down on the way out."""
        import copy

        from ray_tpu_torch.tune.trainable import wrap_function

        base = self

        def train_fn(config):
            from ray_tpu_torch.air import session

            trainer = copy.copy(base)
            trainer._train_config = {
                **base._train_config,
                **(config.get("train_loop_config") or {}),
            }
            if "scaling_config" in config:
                trainer.scaling_config = config["scaling_config"]
            # Tune-side restore (failure retry / PBT exploit / experiment
            # resume) arrives as the trial's loaded checkpoint — seed the
            # trainer so workers resume instead of restarting from scratch.
            restored = session.get_checkpoint()
            if restored is not None:
                trainer._resume_checkpoint = restored
            trainer._result_callbacks = list(base._result_callbacks)
            # Trial rounds reuse the train run records: name the run after
            # the trial so the registry/dashboard map trial -> telemetry.
            ctx = session.get_context()
            trainer._run_name = ctx.trial_name or ctx.trial_id or None
            # Forward each result round — with the workers' latest checkpoint,
            # so Tune-side save()/restore() (PBT, retries) is meaningful.
            trainer.add_result_callback(
                lambda m: session.report(m, checkpoint=trainer._latest_checkpoint)
            )
            result = trainer.fit()
            if result.error:
                raise result.error

        train_fn.__name__ = type(base).__name__
        return wrap_function(train_fn)

    # -- dataset sharding ----------------------------------------------------

    def _dataset_shard_fn(self, rank: int, world_size: int) -> Optional[dict]:
        """A Dataset (anything with `streaming_split`) gives rank r the r-th
        of `world_size` iterators over one pass of its stream; a list gives
        rank r items r, r + world_size, ...; any other value goes to every
        rank as it is."""
        if not self._datasets:
            return None
        # streaming_split iterators share ONE coordinator: build the split
        # once per (dataset, world_size) and hand rank-th iterators out.
        # Per-rank splits would each spawn a coordinator whose other n-1
        # queues nobody drains — the feeder blocks and training hangs.
        cache = getattr(self, "_split_cache", None)
        if cache is None:
            cache = self._split_cache = {}
        shards = {}
        for name, ds in self._datasets.items():
            split = getattr(ds, "streaming_split", None)
            if split is not None:
                key = (name, world_size)
                if key not in cache:
                    cache[key] = ds.streaming_split(world_size)
                shards[name] = cache[key][rank]
            elif isinstance(ds, (list, tuple)):
                shards[name] = ds[rank::world_size]
            else:
                shards[name] = ds
        return shards

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
                    name=self._run_name or self.run_config.name or type(self).__name__,
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
                    # Fresh split coordinators per attempt: after a worker
                    # failure the old iterators are mid-stream/exhausted.
                    self._split_cache = {}
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
                self._latest_checkpoint = checkpoint
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
            for callback in self._result_callbacks:
                callback(dict(metrics))
