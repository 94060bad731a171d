"""Trial: one hyperparameter configuration's lifecycle.

Reference: tune/experiment/trial.py — a Trial is pure metadata + state machine;
the controller owns the actor. States follow the reference's:
PENDING → RUNNING → {PAUSED, TERMINATED, ERROR}.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Any, Optional


class Trial:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    PAUSED = "PAUSED"
    TERMINATED = "TERMINATED"
    ERROR = "ERROR"

    def __init__(
        self,
        trainable_name: str,
        config: dict,
        *,
        trial_id: Optional[str] = None,
        experiment_dir: str = "",
        resources: Optional[dict] = None,
        max_failures: int = 0,
    ):
        self.trial_id = trial_id or uuid.uuid4().hex[:8]
        self.trainable_name = trainable_name
        self.config = config
        self.status = Trial.PENDING
        self.resources = resources or {"CPU": 1.0}
        self.max_failures = max_failures
        self.num_failures = 0
        self.experiment_dir = experiment_dir
        self.last_result: dict = {}
        self.results: list[dict] = []
        self.checkpoint = None  # in-memory Checkpoint (latest)
        self.error_msg: Optional[str] = None
        self.start_time: Optional[float] = None
        self.iteration = 0

        # Controller-owned runtime handles (not serialized).
        self.actor = None
        self.future = None

    @property
    def local_dir(self) -> str:
        d = os.path.join(self.experiment_dir, f"trial_{self.trial_id}")
        os.makedirs(d, exist_ok=True)
        return d

    def set_status(self, status: str) -> None:
        self.status = status
        if status == Trial.RUNNING and self.start_time is None:
            self.start_time = time.time()

    def should_recover(self) -> bool:
        return self.num_failures <= self.max_failures

    def metadata(self) -> dict:
        return {
            "trial_id": self.trial_id,
            "trainable_name": self.trainable_name,
            "config": _jsonable(self.config),
            "status": self.status,
            "iteration": self.iteration,
            "last_result": _jsonable(self.last_result),
            "error": self.error_msg,
        }

    def __repr__(self):
        return f"Trial({self.trial_id}, {self.status}, it={self.iteration})"


def _jsonable(obj: Any) -> Any:
    try:
        json.dumps(obj)
        return obj
    except (TypeError, ValueError):
        return repr(obj)
