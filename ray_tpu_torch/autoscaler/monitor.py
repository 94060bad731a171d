"""Monitor — the daemon loop driving the autoscaler.

Reference: autoscaler/_private/monitor.py (head-node daemon polling GCS load →
StandardAutoscaler.update). Here it is a thread on the head runtime; a
scheduler demand listener triggers an immediate update so infeasible tasks
don't wait for the next poll tick (the reference gets the same effect from the
GCS reporting pending demand every round).
"""

from __future__ import annotations

import threading
from typing import Optional

from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler
from ray_tpu_torch.autoscaler.load_metrics import LoadMetrics
from ray_tpu_torch.autoscaler.node_provider import FakeNodeProvider, NodeProvider


class Monitor:
    def __init__(
        self,
        runtime,
        config: dict,
        provider: Optional[NodeProvider] = None,
        update_interval_s: float = 5.0,
    ):
        self.runtime = runtime
        self.provider = provider or FakeNodeProvider(runtime)
        self.load_metrics = LoadMetrics(runtime)
        self.autoscaler = StandardAutoscaler(config, self.provider, self.load_metrics)
        self.update_interval_s = update_interval_s
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Monitor":
        # Infeasible/pending demand wakes the loop immediately; registering
        # the listener also switches the scheduler from fail-on-infeasible to
        # queue-and-wait (the autoscaler will provision for it). stop()
        # removes it, restoring fail-fast.
        self._listener = lambda *_: self._kick.set()
        self.runtime.scheduler.add_demand_listener(self._listener)
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="autoscaler-monitor"
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        # First iteration runs immediately (min_workers bring-up); transient
        # errors on any round, including the first, must not kill the daemon.
        first = True
        while not self._stop.is_set():
            if not first:
                self._kick.wait(self.update_interval_s)
                self._kick.clear()
            first = False
            if self._stop.is_set():
                return
            try:
                self.autoscaler.update()
            except Exception:  # pragma: no cover — keep the daemon alive
                import traceback

                traceback.print_exc()

    def update_now(self) -> None:
        """Synchronous reconcile (tests / CLI)."""
        self.autoscaler.update()

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()
        if getattr(self, "_listener", None) is not None:
            self.runtime.scheduler.remove_demand_listener(self._listener)
            self._listener = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
