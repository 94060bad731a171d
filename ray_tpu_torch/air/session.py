"""Training session API — what user train loops call.

Reference: air/session.py (report :43, get_checkpoint :97, get_dataset_shard
:359) backed by train/_internal/session.py's rendezvous queue (:76,:421): each
worker runs the user loop on a runner thread; `report` blocks until the driver
consumes the result, which is what makes scheduler-driven early stopping (ASHA
kill mid-epoch) safe.

The active session lives in thread-local state set by the worker runner.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint

_TL = threading.local()


@dataclass
class TrainContext:
    world_rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    node_rank: int = 0
    trial_name: str = ""
    trial_id: str = ""
    # The worker's torch.device, installed by the backend (TorchBackend).
    device: Any = None
    extras: dict = field(default_factory=dict)


class _Session:
    """One per worker-runner thread."""

    FINISHED = object()

    def __init__(self, context: TrainContext, checkpoint: Optional[Checkpoint],
                 dataset_shards: Optional[dict] = None, profiler=None):
        self.context = context
        self.loaded_checkpoint = checkpoint
        self.dataset_shards = dataset_shards or {}
        # train.observability.StepProfiler when TrainConfig.instrument is on;
        # None compiles the telemetry plane out of report()/the hook sites.
        self.profiler = profiler
        # 1-deep rendezvous: report() blocks until the driver consumes.
        self.result_queue: "queue.Queue" = queue.Queue(maxsize=1)
        self.stop_event = threading.Event()

    def report(self, metrics: dict, checkpoint: Optional[Checkpoint]) -> None:
        if self.stop_event.is_set():
            raise StopIteration("Training stopped by the driver")
        item = {"metrics": dict(metrics), "checkpoint": checkpoint}
        profiler = self.profiler
        if profiler is not None:
            # Close the round just before the rendezvous so its record
            # rides this report; the put's blocking time is attributed to
            # the NEXT round's `report` phase (it is that round's start).
            item["profile"] = profiler.end_round()
            t0 = time.perf_counter()
            self.result_queue.put(item)
            profiler.add("report", time.perf_counter() - t0)
        else:
            self.result_queue.put(item)
        if self.stop_event.is_set():
            raise StopIteration("Training stopped by the driver")

    def finish(self) -> None:
        self.result_queue.put(self.FINISHED)


def _set_session(session: Optional[_Session]) -> None:
    _TL.session = session


def _get_session() -> Optional[_Session]:
    return getattr(_TL, "session", None)


def _require_session() -> _Session:
    session = _get_session()
    if session is None:
        raise RuntimeError(
            "No training session active; this API must be called inside a "
            "train_loop_per_worker"
        )
    return session


# -- public API --------------------------------------------------------------


def report(metrics: dict, *, checkpoint: Optional[Checkpoint] = None) -> None:
    _require_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return _require_session().loaded_checkpoint


def get_dataset_shard(name: str = "train"):
    session = _require_session()
    shards = session.dataset_shards
    if name not in shards:
        raise KeyError(f"No dataset shard named {name!r}; have {list(shards)}")
    # Shards are plain lists (DataParallelTrainer refuses Datasets until
    # the data slice), already materialized: nothing to wait on.
    return shards[name]


def get_world_rank() -> int:
    return _require_session().context.world_rank


def get_world_size() -> int:
    return _require_session().context.world_size


def get_local_rank() -> int:
    return _require_session().context.local_rank


def get_context() -> TrainContext:
    return _require_session().context


def get_device():
    """The torch.device the backend chose for this worker (TorchTrainer);
    the counterpart of the reference's get_mesh()."""
    return _require_session().context.device
