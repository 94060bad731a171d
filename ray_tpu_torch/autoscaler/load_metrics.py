"""LoadMetrics — the autoscaler's snapshot of cluster load.

Reference: autoscaler/_private/load_metrics.py fed by the GCS monitor RPC
(gcs_autoscaler_state_manager.h): pending resource demands (queued tasks +
actors), pending placement-group bundles, and per-node idle state. Here the
snapshot reads the in-process control plane directly — the autoscaler still
never talks to execution engines, only to control-plane state (reference
invariant: 'the autoscaler never talks to raylets', SURVEY.md A.7).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class LoadSnapshot:
    pending_demands: List[dict] = field(default_factory=list)  # task/actor asks
    # per pending PG: (strategy, bundles) — the demand scheduler needs the
    # strategy to know how many distinct hosts a gang requires
    pending_bundles: List[tuple] = field(default_factory=list)
    idle_nodes: Dict[str, float] = field(default_factory=dict)  # node_id hex -> idle s
    busy_nodes: List[str] = field(default_factory=list)


class LoadMetrics:
    def __init__(self, runtime):
        self.runtime = runtime
        self._last_busy: dict = {}

    def snapshot(self) -> LoadSnapshot:
        from ray_tpu_torch._private.controller import PlacementGroupState

        snap = LoadSnapshot()
        snap.pending_demands = list(self.runtime.scheduler.pending_demand())
        for record in self.runtime.controller.placement_groups.values():
            if record.state == PlacementGroupState.PENDING:
                snap.pending_bundles.append(
                    (record.strategy, [dict(b) for b in record.bundles])
                )
        now = time.monotonic()
        alive_keys = set()
        for node in self.runtime.controller.alive_nodes():
            alive_keys.add(node.node_id)
            key = node.node_id
            # Busy = anything allocated beyond the synthetic PG wildcards'
            # committed-but-unused capacity; idle time measured since the
            # node last had an allocation.
            busy = any(
                node.available.get(k, 0.0) + 1e-9 < v for k, v in node.total.items()
            )
            if busy:
                self._last_busy[key] = now
                snap.busy_nodes.append(key.hex())
            else:
                # Never-busy nodes idle from the first time we saw them.
                self._last_busy.setdefault(key, now)
                snap.idle_nodes[key.hex()] = now - self._last_busy[key]
        # Prune departed nodes so churn doesn't grow the dict unboundedly.
        for key in list(self._last_busy):
            if key not in alive_keys:
                del self._last_busy[key]
        return snap
