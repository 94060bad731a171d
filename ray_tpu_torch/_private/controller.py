"""Cluster control plane — the GCS equivalent.

Re-designs src/ray/gcs/gcs_server for an in-process control plane: node table
(GcsNodeManager), actor directory + named actors (GcsActorManager), internal KV
(GcsKvManager), and placement groups with prepare/commit 2PC
(GcsPlacementGroupManager/Scheduler, gcs_placement_group_scheduler.cc).

The reference runs these as gRPC services on one asio event loop; here they are
lock-protected tables mutated by calls from the runtime. State transitions and
the PG 2PC structure are preserved so the cross-process backend can slot in
underneath without changing callers.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Any, Optional

from ray_tpu_torch._private.ids import ActorID, NodeID, PlacementGroupID
from ray_tpu_torch.exceptions import OutOfResourcesError, PlacementGroupError

_EPS = 1e-9


# ---------------------------------------------------------------------------
# Nodes & resources
# ---------------------------------------------------------------------------


class NodeState:
    """A schedulable node: total/available resource vectors + labels.

    Resource accounting mirrors the raylet's LocalResourceManager: synthetic
    per-placement-group resources (`<res>_group_<idx>_<pgid>`) are added at PG
    commit and removed at PG removal (raylet/placement_group_resource_manager.h).
    """

    def __init__(self, node_id: NodeID, resources: dict[str, float], labels=None):
        self.node_id = node_id
        self.labels = labels or {}
        self.alive = True
        self._lock = threading.Lock()
        self.total = {k: float(v) for k, v in resources.items() if v}
        self.available = dict(self.total)

    def feasible(self, request: dict[str, float]) -> bool:
        # Locked: the scheduler thread scores nodes while PG commit /
        # autoscaler threads mutate the resource vectors under the lock;
        # an unlocked multi-key read could see a half-applied update and
        # mis-place (found by lint RTL201).
        with self._lock:
            return all(
                self.total.get(k, 0.0) + _EPS >= v
                for k, v in request.items()
            )

    def can_allocate(self, request: dict[str, float]) -> bool:
        with self._lock:
            return self._can_allocate_locked(request)

    def _can_allocate_locked(self, request: dict[str, float]) -> bool:
        """Caller must hold self._lock (non-reentrant)."""
        return all(
            self.available.get(k, 0.0) + _EPS >= v
            for k, v in request.items()
        )

    def allocate(self, request: dict[str, float]) -> bool:
        with self._lock:
            if not self.alive or not self._can_allocate_locked(request):
                return False
            for k, v in request.items():
                self.available[k] = self.available.get(k, 0.0) - v
            return True

    def release(self, request: dict[str, float]) -> None:
        with self._lock:
            for k, v in request.items():
                self.available[k] = min(
                    self.total.get(k, 0.0), self.available.get(k, 0.0) + v
                )

    def add_resources(self, extra: dict[str, float]) -> None:
        with self._lock:
            for k, v in extra.items():
                self.total[k] = self.total.get(k, 0.0) + v
                self.available[k] = self.available.get(k, 0.0) + v

    def remove_resources(self, names: list[str]) -> None:
        with self._lock:
            for k in names:
                self.total.pop(k, None)
                self.available.pop(k, None)

    def utilization(self, request: dict[str, float]) -> float:
        """Critical-resource utilization after hypothetically granting `request`
        (hybrid_scheduling_policy.h:29-50 scoring)."""
        score = 0.0
        with self._lock:
            for k, v in request.items():
                total = self.total.get(k, 0.0)
                if total <= 0:
                    return 1.0
                used = total - self.available.get(k, 0.0) + v
                score = max(score, used / total)
        return score


# ---------------------------------------------------------------------------
# Actors
# ---------------------------------------------------------------------------


class ActorState(enum.Enum):
    PENDING = "PENDING_CREATION"
    ALIVE = "ALIVE"
    RESTARTING = "RESTARTING"
    DEAD = "DEAD"


@dataclass
class ActorRecord:
    actor_id: ActorID
    name: Optional[str]
    namespace: str
    state: ActorState = ActorState.PENDING
    node_id: Optional[NodeID] = None
    num_restarts: int = 0
    max_restarts: int = 0
    death_cause: Optional[str] = None
    detached: bool = False
    class_name: str = ""


# ---------------------------------------------------------------------------
# Placement groups
# ---------------------------------------------------------------------------


class PlacementGroupState(enum.Enum):
    PENDING = "PENDING"
    CREATED = "CREATED"
    REMOVED = "REMOVED"


@dataclass
class PlacementGroupRecord:
    pg_id: PlacementGroupID
    bundles: list[dict[str, float]]
    strategy: str
    name: str = ""
    state: PlacementGroupState = PlacementGroupState.PENDING
    # bundle index -> node the bundle is committed on
    bundle_nodes: dict[int, NodeID] = field(default_factory=dict)
    ready_event: threading.Event = field(default_factory=threading.Event)


def pg_resource_name(base: str, pg_id: PlacementGroupID, index: int | None) -> str:
    """Synthetic resource names for committed bundles (reference naming:
    `CPU_group_<idx>_<pgid>` indexed / `CPU_group_<pgid>` wildcard)."""
    if index is None:
        return f"{base}_group_{pg_id.hex()}"
    return f"{base}_group_{index}_{pg_id.hex()}"


# ---------------------------------------------------------------------------
# Controller
# ---------------------------------------------------------------------------


DEAD_NODES_KEPT = 1000


class Controller:
    def __init__(self):
        self._lock = threading.RLock()
        self.nodes: dict[NodeID, NodeState] = {}
        # Nodes that left, newest last (at most DEAD_NODES_KEPT): the state
        # API and the dashboard list them DEAD (ROADMAP.md §D31).
        self.dead_nodes: dict[NodeID, NodeState] = {}
        self.head_node_id: Optional[NodeID] = None
        self.actors: dict[ActorID, ActorRecord] = {}
        self._named_actors: dict[tuple[str, str], ActorID] = {}
        self.placement_groups: dict[PlacementGroupID, PlacementGroupRecord] = {}
        self._kv: dict[bytes, bytes] = {}
        self._job_counter = 0
        # Listeners poked when cluster resources change (scheduler wakeups).
        self._resource_listeners: list = []

    # -- jobs ---------------------------------------------------------------

    def next_job_id(self) -> int:
        with self._lock:
            self._job_counter += 1
            return self._job_counter

    # -- nodes --------------------------------------------------------------

    def register_node(self, node: NodeState, is_head: bool = False) -> None:
        with self._lock:
            self.nodes[node.node_id] = node
            if is_head or self.head_node_id is None:
                self.head_node_id = node.node_id
        self._notify_resources()

    def remove_node(self, node_id: NodeID) -> Optional[NodeState]:
        with self._lock:
            node = self.nodes.pop(node_id, None)
            if node is not None:
                node.alive = False
                self.dead_nodes[node_id] = node
                while len(self.dead_nodes) > DEAD_NODES_KEPT:
                    self.dead_nodes.pop(next(iter(self.dead_nodes)))
        self._notify_resources()
        return node

    def alive_nodes(self) -> list[NodeState]:
        with self._lock:
            return [n for n in self.nodes.values() if n.alive]

    def add_resource_listener(self, fn) -> None:
        self._resource_listeners.append(fn)

    def _notify_resources(self) -> None:
        for fn in self._resource_listeners:
            fn()

    # -- actors -------------------------------------------------------------

    def register_actor(self, record: ActorRecord) -> None:
        with self._lock:
            if record.name:
                key = (record.namespace, record.name)
                existing_id = self._named_actors.get(key)
                if existing_id is not None:
                    existing = self.actors.get(existing_id)
                    if existing is not None and existing.state != ActorState.DEAD:
                        raise ValueError(
                            f"Actor name {record.name!r} already taken in "
                            f"namespace {record.namespace!r}"
                        )
                self._named_actors[key] = record.actor_id
            self.actors[record.actor_id] = record

    def get_actor_record(self, actor_id: ActorID) -> Optional[ActorRecord]:
        with self._lock:
            return self.actors.get(actor_id)

    def get_named_actor(self, name: str, namespace: str) -> Optional[ActorID]:
        with self._lock:
            actor_id = self._named_actors.get((namespace, name))
            if actor_id is None:
                return None
            record = self.actors.get(actor_id)
            if record is None or record.state == ActorState.DEAD:
                return None
            return actor_id

    def mark_actor_dead(self, actor_id: ActorID, cause: str) -> None:
        with self._lock:
            record = self.actors.get(actor_id)
            if record is None:
                return
            record.state = ActorState.DEAD
            record.death_cause = cause
            if record.name:
                self._named_actors.pop((record.namespace, record.name), None)

    def list_actors(self) -> list[ActorRecord]:
        with self._lock:
            return list(self.actors.values())

    # -- internal KV (GcsKvManager; backs ray.experimental.internal_kv) ------

    def kv_put(self, key: bytes, value: bytes, overwrite: bool = True) -> bool:
        with self._lock:
            if not overwrite and key in self._kv:
                return False
            self._kv[key] = value
            return True

    def kv_get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._kv.get(key)

    def kv_del(self, key: bytes) -> bool:
        with self._lock:
            return self._kv.pop(key, None) is not None

    def kv_keys(self, prefix: bytes = b"") -> list[bytes]:
        with self._lock:
            return [k for k in self._kv if k.startswith(prefix)]

    # -- placement groups (2PC; gcs_placement_group_scheduler.cc) ------------

    def create_placement_group(
        self,
        bundles: list[dict[str, float]],
        strategy: str,
        name: str = "",
    ) -> PlacementGroupRecord:
        pg_id = PlacementGroupID.from_random()
        record = PlacementGroupRecord(
            pg_id=pg_id, bundles=[dict(b) for b in bundles], strategy=strategy, name=name
        )
        with self._lock:
            self.placement_groups[pg_id] = record
        self.try_schedule_placement_group(record)
        return record

    def try_schedule_placement_group(self, record: PlacementGroupRecord) -> bool:
        """Pick nodes for all bundles, escrow resources (prepare), then commit
        synthetic group resources. All-or-nothing: any prepare failure rolls
        back every escrow (CancelResourceReserve path)."""
        if record.state != PlacementGroupState.PENDING:
            return record.state == PlacementGroupState.CREATED
        with self._lock:
            nodes = [n for n in self.nodes.values() if n.alive]
            placement = _place_bundles(record.bundles, record.strategy, nodes)
            if placement is None:
                return False
            # Phase 1: prepare (escrow base resources on each node).
            prepared: list[tuple[NodeState, dict[str, float]]] = []
            ok = True
            for idx, node in placement.items():
                bundle = record.bundles[idx]
                # ray-tpu: lint-ignore[RTL404] allocate/release are
                # bool-returning and non-raising; the ok-flag rollback
                # below already covers the only failure mode
                if node.allocate(bundle):
                    prepared.append((node, bundle))
                else:
                    ok = False
                    break
            if not ok:
                for node, bundle in prepared:
                    node.release(bundle)
                return False
            # Phase 2: commit — materialize indexed + wildcard group resources.
            for idx, node in placement.items():
                bundle = record.bundles[idx]
                extra: dict[str, float] = {}
                for res, amount in bundle.items():
                    extra[pg_resource_name(res, record.pg_id, idx)] = amount
                    wildcard = pg_resource_name(res, record.pg_id, None)
                    extra[wildcard] = extra.get(wildcard, 0.0) + amount
                # The bundle marker pins zero-resource tasks to the bundle's
                # node too (reference: the `bundle_group_*` resource added at
                # commit, placement_group_resource_manager.h).
                extra[pg_resource_name("bundle", record.pg_id, idx)] = 1000.0
                wildcard = pg_resource_name("bundle", record.pg_id, None)
                extra[wildcard] = 1000.0
                node.add_resources(extra)
                record.bundle_nodes[idx] = node.node_id
            record.state = PlacementGroupState.CREATED
            record.ready_event.set()
        self._notify_resources()
        return True

    def retry_pending_placement_groups(self) -> None:
        with self._lock:
            pending = [
                r
                for r in self.placement_groups.values()
                if r.state == PlacementGroupState.PENDING
            ]
        for record in pending:
            self.try_schedule_placement_group(record)

    def remove_placement_group(self, pg_id: PlacementGroupID) -> None:
        with self._lock:
            record = self.placement_groups.get(pg_id)
            if record is None or record.state == PlacementGroupState.REMOVED:
                return
            if record.state == PlacementGroupState.CREATED:
                for idx, node_id in record.bundle_nodes.items():
                    node = self.nodes.get(node_id)
                    if node is None:
                        continue
                    bundle = record.bundles[idx]
                    names = [pg_resource_name(r, pg_id, idx) for r in bundle]
                    names.append(pg_resource_name("bundle", pg_id, idx))
                    names.append(pg_resource_name("bundle", pg_id, None))
                    node.remove_resources(names)
                    for res, amount in bundle.items():
                        wildcard = pg_resource_name(res, pg_id, None)
                        with node._lock:
                            if wildcard in node.total:
                                node.total[wildcard] -= amount
                                node.available[wildcard] = max(
                                    0.0, node.available.get(wildcard, 0.0) - amount
                                )
                                if node.total[wildcard] <= _EPS:
                                    node.total.pop(wildcard)
                                    node.available.pop(wildcard, None)
                    node.release(bundle)  # return escrowed base resources
            record.state = PlacementGroupState.REMOVED
            record.ready_event.set()
        self._notify_resources()

    def get_placement_group(self, pg_id: PlacementGroupID):
        with self._lock:
            return self.placement_groups.get(pg_id)


def _place_bundles(
    bundles: list[dict[str, float]],
    strategy: str,
    nodes: list[NodeState],
) -> Optional[dict[int, NodeState]]:
    """Bundle bin-packing (raylet/scheduling/policy/bundle_scheduling_policy.h).

    Greedy against *available* resources with simulated allocation; returns
    bundle-index → node or None if unplaceable now. STRICT_* are hard
    constraints; PACK/SPREAD are best-effort preferences.
    """
    if not nodes:
        return None
    # Snapshot under each node's lock: the task-scheduler thread mutates
    # the resource vectors under it, and dict() over a resizing dict
    # raises — same torn-read hazard as the locked NodeState readers.
    sim: dict = {}
    alive: dict = {}
    for n in nodes:
        with n._lock:
            sim[n.node_id] = dict(n.available)
            alive[n.node_id] = n.alive

    def fits(node: NodeState, bundle: dict[str, float]) -> bool:
        avail = sim[node.node_id]
        return alive[node.node_id] and all(
            avail.get(k, 0.0) + _EPS >= v for k, v in bundle.items()
        )

    def take(node: NodeState, bundle: dict[str, float]) -> None:
        avail = sim[node.node_id]
        for k, v in bundle.items():
            avail[k] = avail.get(k, 0.0) - v

    placement: dict[int, NodeState] = {}

    if strategy == "STRICT_PACK":
        for node in nodes:
            ok = True
            snapshot = dict(sim[node.node_id])
            for bundle in bundles:
                if fits(node, bundle):
                    take(node, bundle)
                else:
                    ok = False
                    break
            if ok:
                return {i: node for i in range(len(bundles))}
            sim[node.node_id] = snapshot
        return None

    if strategy == "STRICT_SPREAD":
        if len(bundles) > len(nodes):
            return None
        used: set[NodeID] = set()
        for idx, bundle in enumerate(bundles):
            chosen = None
            for node in nodes:
                if node.node_id in used:
                    continue
                if fits(node, bundle):
                    chosen = node
                    break
            if chosen is None:
                return None
            used.add(chosen.node_id)
            take(chosen, bundle)
            placement[idx] = chosen
        return placement

    if strategy == "SPREAD":
        order = list(nodes)
        cursor = 0
        for idx, bundle in enumerate(bundles):
            chosen = None
            for offset in range(len(order)):
                node = order[(cursor + offset) % len(order)]
                if fits(node, bundle):
                    chosen = node
                    cursor = (cursor + offset + 1) % len(order)
                    break
            if chosen is None:
                return None
            take(chosen, bundle)
            placement[idx] = chosen
        return placement

    # PACK (default): fill the fewest nodes — sort by current free capacity asc.
    for idx, bundle in enumerate(bundles):
        chosen = None
        for node in sorted(nodes, key=lambda n: sum(sim[n.node_id].values())):
            if fits(node, bundle):
                chosen = node
                break
        if chosen is None:
            return None
        take(chosen, bundle)
        placement[idx] = chosen
    return placement
