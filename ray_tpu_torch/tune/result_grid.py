"""ResultGrid: the Tuner.fit() return value (reference: tune/result_grid.py)."""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch.air.result import Result
from ray_tpu_torch.tune.experiment.trial import Trial


class ResultGrid:
    def __init__(self, trials: List[Trial], metric: Optional[str], mode: str):
        self._trials = trials
        self._metric = metric
        self._mode = mode
        self._results = [
            Result(
                metrics=t.last_result,
                checkpoint=t.checkpoint,
                error=t.error_msg,
                path=t.local_dir,
                metrics_history=t.results,
                config=dict(t.config or {}),
            )
            for t in trials
        ]

    def __len__(self) -> int:
        return len(self._results)

    def __getitem__(self, i: int) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self) -> list:
        return [r.error for r in self._results if r.error]

    @property
    def num_errors(self) -> int:
        return len(self.errors)

    def get_best_result(
        self, metric: Optional[str] = None, mode: Optional[str] = None
    ) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("No metric given to get_best_result")
        scored = [r for r in self._results if metric in (r.metrics or {})]
        if not scored:
            raise RuntimeError("No trial reported the metric " + repr(metric))
        key = lambda r: r.metrics[metric]
        return max(scored, key=key) if mode == "max" else min(scored, key=key)

    def get_dataframe(self):
        """Per-trial final metrics as a pandas DataFrame."""
        import pandas as pd

        rows = []
        for t in self._trials:
            row = {"trial_id": t.trial_id, "status": t.status}
            row.update({k: v for k, v in (t.last_result or {}).items()})
            row.update({f"config/{k}": v for k, v in t.config.items()})
            rows.append(row)
        return pd.DataFrame(rows)
