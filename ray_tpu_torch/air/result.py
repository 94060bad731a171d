"""Training/tuning result (reference: air/result.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ray_tpu_torch.air.checkpoint import Checkpoint


@dataclass
class Result:
    metrics: dict = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    error: Optional[BaseException] = None
    path: Optional[str] = None
    metrics_history: list[dict] = field(default_factory=list)
    config: dict = field(default_factory=dict)
    # Training telemetry snapshot (TrainConfig.instrument): per-phase
    # min/median/max across ranks, round records, straggler report. None
    # when instrumentation is off or the trainer doesn't profile.
    train_report: Optional[dict] = None

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        return self.checkpoint
