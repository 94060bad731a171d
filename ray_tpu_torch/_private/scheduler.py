"""Cluster scheduler: queue → policy → dispatch.

Re-designs the reference's two-level scheduler for a shared control plane:
`ClusterTaskManager` (queue → pick node → spillback → infeasible,
raylet/scheduling/cluster_task_manager.h:33-42) collapses into a single dispatch
loop because every node's availability is visible locally — spillback becomes a
no-op. Policies preserved:

  * hybrid (default): nodes scored by critical-resource utilization; prefer the
    local/head node while its score stays under the 0.5 spread threshold, else
    the lowest-utilization node (hybrid_scheduling_policy.h:29-50,
    ray_config_def.h:193).
  * SPREAD: round-robin over feasible nodes.
  * NodeAffinity: hard or soft pin.
  * PlacementGroup: resource request is rewritten onto the bundle's synthetic
    group resources, which also pins the node (affinity_with_bundle policy).

Infeasible tasks (no alive node could *ever* satisfy the request) are failed
eagerly by default; with an autoscaler attached they instead queue and the
demand is reported (cluster_task_manager.h:39-41 → autoscaler).
"""

from __future__ import annotations

import random
import threading
from collections import deque
from typing import Callable, Optional

from ray_tpu_torch._private.config import GLOBAL_CONFIG
from ray_tpu_torch._private.controller import (
    Controller,
    NodeState,
    PlacementGroupState,
    pg_resource_name,
)
from ray_tpu_torch._private.task_spec import TaskSpec
from ray_tpu_torch.exceptions import OutOfResourcesError, PlacementGroupError
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    SPREAD,
)


class PendingTask:
    __slots__ = ("spec", "request", "target_node", "cancelled", "shape", "claimed")

    def __init__(self, spec: TaskSpec, request: dict[str, float]):
        self.spec = spec
        self.request = request
        self.target_node: Optional[NodeState] = None
        self.cancelled = False
        # Set while the pass is dispatching this task: cancel() must not
        # match a task whose dispatch is in flight (it would double-finalize).
        self.claimed = False
        self.shape = _shape_key(spec, request)


def _shape_key(spec: TaskSpec, request: dict[str, float]):
    """Scheduling-equivalence key: two pending tasks with the same shape are
    interchangeable to the placer, so when one fails to place the rest of its
    shape can be skipped for the pass (the reference queues tasks per
    SchedulingClass for exactly this reason, cluster_task_manager.h)."""
    strategy = spec.scheduling_strategy
    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        skey = ("affinity", strategy.node_id, strategy.soft)
    elif isinstance(strategy, PlacementGroupSchedulingStrategy):
        skey = (
            "pg",
            strategy.placement_group.id,
            strategy.placement_group_bundle_index,
        )
    elif strategy == SPREAD:
        skey = ("spread",)
    else:
        skey = ("default",)
    return (skey, tuple(sorted(request.items())))


def resolve_pg_request(
    spec: TaskSpec, request: dict[str, float], controller: Controller
) -> tuple[dict[str, float], Optional[object]]:
    """Rewrite a resource request onto placement-group synthetic resources."""
    strategy = spec.scheduling_strategy
    if not isinstance(strategy, PlacementGroupSchedulingStrategy):
        return request, None
    pg = strategy.placement_group
    record = controller.get_placement_group(pg.id)
    if record is None or record.state == PlacementGroupState.REMOVED:
        raise PlacementGroupError(f"Placement group {pg.id} does not exist")
    index = strategy.placement_group_bundle_index
    rewritten = {
        pg_resource_name(res, pg.id, index if index >= 0 else None): amount
        for res, amount in request.items()
    }
    # Bundle marker: pins the task to the bundle's node even when it
    # requests zero resources (num_cpus=0 actors still belong to the PG).
    rewritten[
        pg_resource_name("bundle", pg.id, index if index >= 0 else None)
    ] = 0.001
    return rewritten, record


class Scheduler:
    def __init__(
        self,
        controller: Controller,
        dispatch: Callable[[TaskSpec, NodeState, dict[str, float]], None],
        fail_task: Callable[[TaskSpec, BaseException], None],
    ):
        self._controller = controller
        self._dispatch = dispatch
        self._fail_task = fail_task
        self._cond = threading.Condition()
        self._queue: deque[PendingTask] = deque()
        self._in_pass: list[PendingTask] = []  # tasks drained into the current pass
        # Unplaceable tasks parked per shape-class (the reference's
        # per-SchedulingClass queues): a resource change probes only each
        # shape's HEAD, so completion-driven passes cost O(#shapes), not
        # O(total queued) — the difference between 2.6M and ~10k queue
        # touches for 5k resource-bound tasks on one node.
        self._blocked: dict = {}
        self._dirty = False  # resources changed since the last blocked probe
        self._spread_cursor = 0
        self._running = True
        self.fail_on_infeasible = True
        # Until this monotonic deadline, infeasible tasks PARK instead of
        # failing: a restarted head restores detached actors/PGs before its
        # daemons have re-registered, and failing them in that gap would
        # defeat the restart (reference: GCS restart grace before actor
        # reconstruction is abandoned).
        self.infeasible_grace_until = 0.0
        # Memory-pressure backpressure: while this returns False, no new
        # leases are handed out (the reference raylet stops dispatch while
        # its memory monitor reports pressure).
        self.dispatch_gate: Callable[[], bool] = lambda: True
        self._demand_listeners: list = []  # autoscaler hook
        self._thread = threading.Thread(
            target=self._loop, name="ray_tpu_torch-scheduler", daemon=True
        )
        self._thread.start()
        controller.add_resource_listener(self.notify)

    # -- public -------------------------------------------------------------

    def submit(self, spec: TaskSpec, request: dict[str, float]) -> None:
        with self._cond:
            self._queue.append(PendingTask(spec, request))
            self._cond.notify_all()

    def cancel(self, task_id) -> bool:
        with self._cond:
            # The current pass's drained batch is still cancellable: the loop
            # re-checks pending.cancelled right before dispatching each task.
            for pending in list(self._queue) + self._in_pass:
                if (
                    pending.spec.task_id == task_id
                    and not pending.cancelled
                    and not pending.claimed
                ):
                    pending.cancelled = True
                    self._cond.notify_all()
                    return True
            # Parked tasks are removed eagerly: the probe loop only ever
            # looks at each shape's head, so a cancelled entry deeper in a
            # deque would otherwise pin its spec (and arg refs) until the
            # shape drains.
            for shape, dq in list(self._blocked.items()):
                for pending in dq:
                    if pending.spec.task_id == task_id and not pending.claimed:
                        pending.cancelled = True
                        dq.remove(pending)
                        if not dq:
                            self._blocked.pop(shape, None)
                        self._cond.notify_all()
                        return True
        return False

    def notify(self) -> None:
        with self._cond:
            self._dirty = True
            self._cond.notify_all()

    def add_demand_listener(self, fn) -> None:
        self._demand_listeners.append(fn)

    def remove_demand_listener(self, fn) -> None:
        """Detach an autoscaler hook; with no listeners left the scheduler
        reverts to failing infeasible tasks fast."""
        try:
            self._demand_listeners.remove(fn)
        except ValueError:
            pass

    def pending_demand(self) -> list[dict[str, float]]:
        with self._cond:
            # Include the pass in flight and parked shapes exactly once: a
            # batch task the pass just parked is in BOTH _in_pass and
            # _blocked until the pass ends.
            demand = [p.request for p in self._queue]
            seen = {id(p) for p in self._queue}
            for dq in self._blocked.values():
                for p in dq:
                    if id(p) not in seen:
                        seen.add(id(p))
                        demand.append(p.request)
            demand.extend(
                p.request for p in self._in_pass if id(p) not in seen
            )
            return demand

    def shutdown(self) -> None:
        with self._cond:
            self._running = False
            self._cond.notify_all()
        self._thread.join(timeout=2.0)

    # -- loop ---------------------------------------------------------------

    def _loop(self) -> None:
        import time as _time

        while True:
            with self._cond:
                while self._running and not self._queue and not (
                    self._dirty and self._blocked
                ):
                    wait_t = None
                    if self._blocked and self.infeasible_grace_until:
                        # Grace window active: nothing else may ever notify
                        # (no nodes, no resource events), so wake AT the
                        # deadline and run one pass to fail still-infeasible
                        # heads — otherwise they'd park forever.
                        left = self.infeasible_grace_until - _time.monotonic()
                        if left <= 0:
                            self.infeasible_grace_until = 0.0
                            self._dirty = True
                            break
                        wait_t = min(left + 0.05, 5.0)
                    self._cond.wait(timeout=wait_t)
                if not self._running:
                    return
                if not self.dispatch_gate():
                    # Host memory pressure: hold the queue until the monitor
                    # clears the gate (it notifies on transition) or a kill
                    # frees memory; the timeout bounds a stuck gate.
                    self._cond.wait(timeout=0.5)
                    continue
                self._dirty = False
                batch = list(self._queue)
                self._queue.clear()
                self._in_pass = batch
            # Parked shapes first (their tasks are older), then new arrivals.
            progressed = self._probe_blocked()
            progressed |= self._schedule_batch(batch)
            # Drop the drained batch BEFORE sleeping: a placed task's spec
            # (and the ObjectRef args it pins) must not stay alive in this
            # loop's locals while the scheduler idles.
            batch = []
            with self._cond:
                self._in_pass = []
                if (
                    not progressed
                    and (self._queue or self._blocked)
                    and not self._dirty
                    and self._running
                ):
                    # Nothing placeable right now; wait for a resource change.
                    self._cond.wait(timeout=0.2)

    def _probe_blocked(self) -> bool:
        """Try each parked shape's HEAD task; drain the shape while heads
        place. Cost per pass: O(#blocked shapes + #newly placeable)."""
        progressed = False
        with self._cond:
            shapes = list(self._blocked.keys())
        for shape in shapes:
            while True:
                with self._cond:
                    dq = self._blocked.get(shape)
                    if not dq:
                        self._blocked.pop(shape, None)
                        break
                    pending = dq[0]
                    if pending.cancelled:
                        dq.popleft()
                        progressed = True
                        continue
                    pending.claimed = True
                outcome = self._try_one(pending)
                with self._cond:
                    if outcome == "blocked":
                        pending.claimed = False
                        break
                    # placed or failed: either way the head is consumed.
                    dq = self._blocked.get(shape)
                    if dq and dq[0] is pending:
                        dq.popleft()
                    if not dq:
                        self._blocked.pop(shape, None)
                progressed = True
                if outcome == "failed":
                    # A PG/infeasibility failure is task-specific (e.g. a
                    # removed placement group): keep probing this shape.
                    continue
        return progressed

    def _schedule_batch(self, batch: list) -> bool:
        """Place newly-arrived tasks; park unplaceable ones by shape."""
        progressed = False
        for pending in batch:
            # Claim under the lock: after this point cancel() returns False
            # for this task (it may already be dispatching).
            with self._cond:
                if pending.cancelled:
                    progressed = True
                    continue
                parked = self._blocked.get(pending.shape)
                if parked:
                    # Same shape already blocked: park behind it (FIFO
                    # within the shape) without a doomed placement attempt.
                    parked.append(pending)
                    continue
                pending.claimed = True
            outcome = self._try_one(pending)
            if outcome == "blocked":
                with self._cond:
                    pending.claimed = False
                    self._blocked.setdefault(pending.shape, deque()).append(
                        pending
                    )
            else:
                progressed = True
        return progressed

    def _try_one(self, pending: PendingTask) -> str:
        """One placement attempt: returns 'placed', 'failed', or 'blocked'.
        Caller holds the claim; 'failed' means the task was failed to its
        caller (PG error / infeasible), 'blocked' means park it."""
        try:
            request, pg_record = resolve_pg_request(
                pending.spec, pending.request, self._controller
            )
        except PlacementGroupError as exc:
            self._fail_task(pending.spec, exc)
            return "failed"
        try:
            node = self._pick_node(pending.spec, request)
        except OutOfResourcesError as exc:
            self._fail_task(pending.spec, exc)
            return "failed"
        if node is None:
            if not self._feasible_anywhere(request) and (
                pg_record is None or pg_record.state == PlacementGroupState.CREATED
            ):
                import time as _time

                if (
                    self.fail_on_infeasible
                    and not self._demand_listeners
                    and _time.monotonic() >= self.infeasible_grace_until
                ):
                    self._fail_task(
                        pending.spec,
                        OutOfResourcesError(
                            f"No node can ever satisfy {request} for task "
                            f"{pending.spec.name}"
                        ),
                    )
                    return "failed"
                for fn in self._demand_listeners:
                    fn(request)
            return "blocked"
        if node.allocate(request):
            self._dispatch(pending.spec, node, request)
            return "placed"
        return "blocked"

    # -- policies -----------------------------------------------------------

    def _feasible_anywhere(self, request: dict[str, float]) -> bool:
        return any(n.feasible(request) for n in self._controller.alive_nodes())

    def _pick_node(
        self, spec: TaskSpec, request: dict[str, float]
    ) -> Optional[NodeState]:
        nodes = self._controller.alive_nodes()
        if not nodes:
            return None
        strategy = spec.scheduling_strategy

        if isinstance(strategy, NodeAffinitySchedulingStrategy):
            target = next(
                (n for n in nodes if n.node_id.hex() == strategy.node_id), None
            )
            if target is not None and target.can_allocate(request):
                return target
            if strategy.soft:
                return self._hybrid_pick(nodes, request)
            if target is None:
                # Hard affinity to a dead/unknown node can never be satisfied
                # (the reference fails these as unschedulable).
                raise OutOfResourcesError(
                    f"Node {strategy.node_id} for hard NodeAffinity is not alive"
                )
            return None

        candidates = [n for n in nodes if n.can_allocate(request)]
        if not candidates:
            return None

        if strategy == SPREAD:
            self._spread_cursor += 1
            return candidates[self._spread_cursor % len(candidates)]

        # PG strategies arrive here with rewritten resources; only nodes holding
        # the group resources are candidates, so hybrid picking is safe.
        return self._hybrid_pick(candidates, request)

    def _hybrid_pick(
        self, candidates: list[NodeState], request: dict[str, float]
    ) -> Optional[NodeState]:
        candidates = [n for n in candidates if n.can_allocate(request)]
        if not candidates:
            return None
        threshold = GLOBAL_CONFIG.scheduler_spread_threshold
        head_id = self._controller.head_node_id
        local = next((n for n in candidates if n.node_id == head_id), None)
        if local is not None and local.utilization(request) < threshold:
            return local
        scored = sorted(candidates, key=lambda n: n.utilization(request))
        top_k = max(1, int(len(scored) * GLOBAL_CONFIG.scheduler_top_k_fraction))
        return random.choice(scored[:top_k])
