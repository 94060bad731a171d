"""Run/scaling/failure/checkpoint configs (reference: python/ray/air/config.py —
ScalingConfig :91, RunConfig :704, FailureConfig :523, CheckpointConfig :574).

ScalingConfig counts workers and the GPUs each one holds
(`gpus_per_worker`, the `GPU` resource); the worker's device itself is the
backend's choice (`TorchBackendConfig.device`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ScalingConfig:
    num_workers: int = 1
    # GPUs each worker reserves from the `GPU` resource; 0 = none reserved.
    gpus_per_worker: int = 0
    cpus_per_worker: float = 1.0
    resources_per_worker: dict[str, float] = field(default_factory=dict)
    # Placement strategy for the worker bundles (default PACK).
    placement_strategy: Optional[str] = None

    def bundle_specs(self) -> list[dict[str, float]]:
        bundle: dict[str, float] = {"CPU": float(self.cpus_per_worker)}
        if self.gpus_per_worker:
            bundle["GPU"] = float(self.gpus_per_worker)
        bundle.update(self.resources_per_worker)
        return [dict(bundle) for _ in range(self.num_workers)]

    def strategy(self) -> str:
        return self.placement_strategy or "PACK"


@dataclass
class FailureConfig:
    # Number of worker-group restarts allowed; -1 = unlimited.
    max_failures: int = 0


@dataclass
class TrainConfig:
    """Training-plane knobs (the `EngineConfig.instrument` mirror).

    instrument: per-round step profiling, `train.*` spans, `train_*`
        histograms, straggler detection, and the run registry
        (`train.list_runs`). Off compiles the whole plane out of the
        report path (sessions get no profiler, hooks see None).
    straggler_factor/straggler_min_s: a rank is flagged when its non-report
        work time exceeds the low-median across ranks by `straggler_factor`
        AND by at least `straggler_min_s` (absolute floor so near-zero
        rounds don't flag on noise).
    profiler_capacity: per-worker round-record ring size.
    rounds_capacity: driver-side per-run round-record ring size.
    """

    instrument: bool = True
    straggler_factor: float = 2.0
    straggler_min_s: float = 0.05
    profiler_capacity: int = 512
    rounds_capacity: int = 256


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"  # "max" | "min"
    # Tune: save each trial at its end, and every N iterations (0 = never).
    checkpoint_at_end: bool = True
    checkpoint_frequency: int = 0

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    # Tune stopping criteria, e.g. {"training_iteration": 10}.
    stop: Optional[dict] = None

    def resolved_storage_path(self) -> str:
        # The port's own root: never the reference's ~/ray_tpu_results.
        base = self.storage_path or os.path.join(
            os.path.expanduser("~"), "ray_tpu_torch_results"
        )
        return os.path.join(base, self.name) if self.name else base
