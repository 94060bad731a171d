"""StandardAutoscaler — reconcile cluster size against load.

Reference: autoscaler/_private/autoscaler.py:172,374,386 (StandardAutoscaler
.update: terminate out-of-config/idle nodes, then launch for unfulfilled
demand under the upscaling_speed throttle). Config shape follows the
reference's cluster YAML (available_node_types / max_workers / idle_timeout),
with the reference's addition that a node type can be a multi-host group
(hosts_per_slice) which scales as a unit.
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Dict, Optional

from ray_tpu_torch.autoscaler.load_metrics import LoadMetrics
from ray_tpu_torch.autoscaler.node_provider import (
    TAG_NODE_TYPE,
    TAG_SLICE_ID,
    NodeProvider,
)
from ray_tpu_torch.autoscaler.resource_demand_scheduler import ResourceDemandScheduler

logger = logging.getLogger(__name__)


class StandardAutoscaler:
    def __init__(
        self,
        config: dict,
        provider: NodeProvider,
        load_metrics: LoadMetrics,
    ):
        self.config = config
        self.provider = provider
        self.load_metrics = load_metrics
        self.node_types: Dict[str, dict] = config.get("available_node_types", {})
        self.demand_scheduler = ResourceDemandScheduler(self.node_types)
        self.max_workers = int(config.get("max_workers", 64))
        self.idle_timeout_s = float(config.get("idle_timeout_s", 60.0))
        self.upscaling_speed = float(config.get("upscaling_speed", 1.0))
        self._lock = threading.Lock()
        self.num_launches = 0
        self.num_terminations = 0
        # Capacity launched but (for real cloud providers) not yet joined the
        # runtime — counted as available so the next poll round doesn't
        # re-launch for the same demand (reference: 'plus already-launching
        # nodes'). Entries expire after launch_grace_s as a failsafe.
        self.launch_grace_s = float(config.get("launch_grace_s", 120.0))
        self._pending_launches: list = []  # [(deadline, provider_id, resources)]

    # -- helpers ----------------------------------------------------------

    def _worker_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        seen_slices = set()
        for pid in self.provider.non_terminated_nodes():
            tags = self.provider.node_tags(pid)
            node_type = tags.get(TAG_NODE_TYPE)
            if node_type is None:
                continue
            slice_id = tags.get(TAG_SLICE_ID)
            if slice_id:
                if slice_id in seen_slices:
                    continue  # count a slice once, not per host
                seen_slices.add(slice_id)
            counts[node_type] = counts.get(node_type, 0) + 1
        return counts

    def _ensure_min_workers(self, counts: Dict[str, int]) -> Dict[str, int]:
        launches: Dict[str, int] = {}
        for type_name, cfg in self.node_types.items():
            deficit = int(cfg.get("min_workers", 0)) - counts.get(type_name, 0)
            if deficit > 0:
                launches[type_name] = deficit
        return launches

    # -- main loop --------------------------------------------------------

    def update(self) -> None:
        with self._lock:
            self._update_locked()

    def _update_locked(self) -> None:
        snap = self.load_metrics.snapshot()
        counts = self._worker_counts()

        # 1. Terminate idle workers above min_workers (never the head; slices
        #    terminate whole or not at all — any busy host pins the slice).
        idle = snap.idle_nodes
        provider_nodes = self.provider.non_terminated_nodes()
        runtime_to_provider = {}
        slice_members: Dict[str, list] = {}
        for pid in provider_nodes:
            tags = self.provider.node_tags(pid)
            rt_node = getattr(self.provider, "runtime_node_id", lambda _: None)(pid)
            if rt_node is not None:
                runtime_to_provider[rt_node.hex()] = pid
            sid = tags.get(TAG_SLICE_ID)
            if sid:
                slice_members.setdefault(sid, []).append(pid)

        terminated_slices = set()
        for node_hex, idle_s in idle.items():
            if idle_s < self.idle_timeout_s:
                continue
            pid = runtime_to_provider.get(node_hex)
            if pid is None:
                continue
            tags = self.provider.node_tags(pid)
            node_type = tags.get(TAG_NODE_TYPE)
            cfg = self.node_types.get(node_type, {})
            if counts.get(node_type, 0) <= int(cfg.get("min_workers", 0)):
                continue
            sid = tags.get(TAG_SLICE_ID)
            if sid:
                if sid in terminated_slices:
                    continue
                members = slice_members.get(sid, [])
                # Terminate the slice only if EVERY host is past the timeout.
                member_hexes = {
                    getattr(self.provider, "runtime_node_id")(m).hex() for m in members
                }
                if not all(
                    idle.get(h, 0.0) >= self.idle_timeout_s for h in member_hexes
                ):
                    continue
                for m in members:
                    self.provider.terminate_node(m)
                    self.num_terminations += 1
                terminated_slices.add(sid)
            else:
                self.provider.terminate_node(pid)
                self.num_terminations += 1
            counts[node_type] = counts.get(node_type, 0) - 1

        # 2. Launch: min_workers deficits + demand-driven. Launched-but-not-
        #    yet-joined capacity counts as available so repeat rounds don't
        #    over-provision for the same demand.
        import time as _time

        now = _time.monotonic()
        alive_runtime_ids = {
            n.node_id.hex()
            for n in self.load_metrics.runtime.controller.alive_nodes()
        }
        still_pending = []
        for deadline, pid, resources in self._pending_launches:
            rt_node = getattr(self.provider, "runtime_node_id", lambda _: None)(pid)
            joined = rt_node is not None and rt_node.hex() in alive_runtime_ids
            if not joined and now < deadline:
                still_pending.append((deadline, pid, resources))
        self._pending_launches = still_pending

        to_launch = self._ensure_min_workers(counts)
        node_avail = [
            dict(n.available) for n in self.load_metrics.runtime.controller.alive_nodes()
        ] + [dict(resources) for _, _, resources in self._pending_launches]
        demand_launches = self.demand_scheduler.get_nodes_to_launch(
            node_avail,
            snap.pending_demands,
            snap.pending_bundles,
            counts,
        )
        for t, c in demand_launches.items():
            to_launch[t] = max(to_launch.get(t, 0), c)

        # 3. Throttle: at most upscaling_speed * current (min 5) new nodes
        #    per round (reference autoscaler.py:386).
        total_now = sum(counts.values()) or 1
        budget = max(5, int(math.ceil(self.upscaling_speed * total_now)))
        total_workers = sum(counts.values())
        for type_name, count in to_launch.items():
            cfg = self.node_types.get(type_name)
            if cfg is None:
                continue
            count = min(count, budget)
            headroom = self.max_workers - total_workers
            count = min(count, max(0, headroom))
            if count <= 0:
                continue
            created = self.provider.create_node(type_name, cfg, count)
            deadline = now + self.launch_grace_s
            for pid in created:
                self._pending_launches.append(
                    (deadline, pid, dict(cfg.get("resources", {})))
                )
            self.num_launches += count
            budget -= count
            total_workers += count

        # Re-kick pending placement groups now that capacity changed.
        self.load_metrics.runtime.controller.retry_pending_placement_groups()
        self.load_metrics.runtime.scheduler.notify()
