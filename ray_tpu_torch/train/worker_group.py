"""WorkerGroup — N training-worker actors in a placement group.

Reference: train/_internal/worker_group.py:100 (WorkerGroup), :18
(RayTrainWorker); placement via backend_executor.py:164. The worker actor runs
the user's train loop on a runner thread (train/_internal/session.py:147
RunnerThread) and serves `next_result` from the rendezvous queue.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from typing import Any, Callable, Optional

import ray_tpu_torch
from ray_tpu_torch.air.session import TrainContext, _Session, _set_session
from ray_tpu_torch.util import (
    PlacementGroupSchedulingStrategy,
    placement_group,
    remove_placement_group,
)

# How long shutdown() waits for a stopped loop to finish its step.
STOP_TIMEOUT_S = 120.0


@ray_tpu_torch.remote
class RayTrainWorker:
    """One training worker. Methods are called by the BackendExecutor."""

    def __init__(self, context_kwargs: dict):
        self.context = TrainContext(**context_kwargs)
        self.session: Optional[_Session] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[dict] = None
        self.profiler = None  # StepProfiler while instrumented training runs

    # -- backend hooks -------------------------------------------------------

    def run_fn(self, fn: Callable, *args, **kwargs):
        """Execute an arbitrary function on the worker (backend setup)."""
        return fn(self.context, *args, **kwargs)

    def get_context(self) -> dict:
        return {
            "world_rank": self.context.world_rank,
            "world_size": self.context.world_size,
            "local_rank": self.context.local_rank,
            "node_rank": self.context.node_rank,
        }

    # -- training ------------------------------------------------------------

    def start_training(
        self,
        train_fn: Callable,
        config: dict,
        checkpoint,
        dataset_shards: Optional[dict] = None,
        observability: Optional[dict] = None,
    ) -> None:
        profiler = None
        if observability is not None:
            from ray_tpu_torch.train.observability import StepProfiler

            profiler = StepProfiler(
                rank=self.context.world_rank,
                world_size=self.context.world_size,
                trace=observability.get("trace"),
                round_offset=observability.get("round_offset", 0),
                capacity=observability.get("capacity", 512),
            )
        self.profiler = profiler
        session = _Session(
            self.context, checkpoint, dataset_shards, profiler=profiler
        )
        self.session = session
        self._error = None

        def runner():
            _set_session(session)
            try:
                if config:
                    train_fn(config)
                else:
                    try:
                        train_fn({})
                    except TypeError:
                        train_fn()
                session.finish()
            except StopIteration:
                session.finish()
            except BaseException as exc:  # noqa: BLE001
                self._error = {
                    "exception": exc,
                    "traceback": traceback.format_exc(),
                }
                try:
                    session.result_queue.put(session.FINISHED, timeout=1)
                except Exception:
                    pass
            finally:
                _set_session(None)

        self._thread = threading.Thread(target=runner, daemon=True, name="train-runner")
        self._thread.start()

    def next_result(self) -> Optional[dict]:
        """Block for the next report; None when the loop finished. Raises the
        user exception if the loop died (reference: TrainingIterator error
        handling, train/trainer.py:110)."""
        assert self.session is not None, "start_training not called"
        item = self.session.result_queue.get()
        if item is self.session.FINISHED:
            if self._error is not None:
                raise self._error["exception"]
            return None
        return item

    def stop(self) -> bool:
        """Stop the loop: every report() raises StopIteration from now on.
        Keep draining the rendezvous (a parked report()'s put, then the
        runner's finish()) until the runner thread has ended or
        STOP_TIMEOUT_S passed; returns whether it ended. Its model and
        optimizer state go with the thread's frames."""
        if self.session is None:
            return True
        self.session.stop_event.set()
        deadline = time.monotonic() + STOP_TIMEOUT_S
        while True:
            # Unblock a report() waiting for a consumer.
            try:
                self.session.result_queue.get_nowait()
            except queue.Empty:
                pass
            if self.shutdown_check() or time.monotonic() >= deadline:
                return self.shutdown_check()
            self._thread.join(timeout=0.01)

    def shutdown_check(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    def profile_records(self) -> list:
        """This worker's bounded ring of per-round phase records
        (train/observability.StepProfiler); [] when not instrumented."""
        if self.profiler is None:
            return []
        return list(self.profiler.records)


class WorkerGroup:
    """Creates/destroys the actor set + its placement group."""

    def __init__(
        self,
        num_workers: int,
        bundle_specs: list[dict[str, float]],
        strategy: str,
    ):
        self.num_workers = num_workers
        self._pg = placement_group(bundle_specs, strategy=strategy)
        if not self._pg.ready(timeout=60.0):
            raise RuntimeError("Training placement group could not be scheduled")
        bundle_nodes = self._pg.bundle_node_ids()
        # node_rank: distinct nodes in bundle order.
        node_order: dict[str, int] = {}
        self.workers = []
        for rank in range(num_workers):
            node_id = bundle_nodes.get(rank, "")
            node_rank = node_order.setdefault(node_id, len(node_order))
            context_kwargs = dict(
                world_rank=rank,
                world_size=num_workers,
                local_rank=0,
                node_rank=node_rank,
            )
            worker = RayTrainWorker.options(
                num_cpus=0,
                # next_result() blocks awaiting the runner thread; stop() and
                # backend run_fn calls must be able to interleave.
                max_concurrency=8,
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=self._pg,
                    placement_group_bundle_index=rank,
                ),
                resources={},
            ).remote(context_kwargs)
            self.workers.append(worker)

    def execute(self, fn: Callable, *args, **kwargs) -> list:
        """Run fn(context, *args) on every worker, gather results."""
        return ray_tpu_torch.get(
            [w.run_fn.remote(fn, *args, **kwargs) for w in self.workers],
            timeout=300.0,
        )

    def execute_single(self, rank: int, fn: Callable, *args, **kwargs):
        return ray_tpu_torch.get(
            self.workers[rank].run_fn.remote(fn, *args, **kwargs), timeout=300.0
        )

    def profile_records(self) -> list[list]:
        """Per-rank round-record rings (rank-indexed)."""
        return ray_tpu_torch.get(
            [w.profile_records.remote() for w in self.workers], timeout=60.0
        )

    @property
    def placement_group(self):
        return self._pg

    def shutdown(self) -> None:
        # End every runner thread before the kill. A loop stopped from
        # outside (Tune's STOP reaching fit() through its report) is parked
        # in report()'s rendezvous one round ahead, holding its model and
        # optimizer state; killing the actor alone would leave that thread,
        # and the card memory it holds, alive.
        try:
            ray_tpu_torch.get(
                [w.stop.remote() for w in self.workers],
                timeout=STOP_TIMEOUT_S + 10.0,
            )
        except Exception:
            pass
        for worker in self.workers:
            try:
                ray_tpu_torch.kill(worker)
            except Exception:
                pass
        self.workers = []
        try:
            remove_placement_group(self._pg)
        except Exception:
            pass
