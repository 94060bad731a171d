"""Per-subsystem runtime gauges — the standard metric suite.

Reference: src/ray/stats/metric_defs.h:46-88 (the canonical gauge set every
Ray process exports: scheduler/task-state counts, object store usage,
node/actor liveness) + the reporter agent. Here one sampler
refreshes the suite from the runtime's state tables; `prometheus_text()`
(util/metrics.py) renders it alongside user-defined metrics.
"""

from __future__ import annotations

import threading
from typing import Optional

from ray_tpu_torch.util.metrics import Gauge

_GAUGES: Optional[dict] = None
_GAUGE_LOCK = threading.Lock()


def _gauges() -> dict:
    global _GAUGES
    from ray_tpu_torch.util import metrics as _metrics

    with _GAUGE_LOCK:
        if _GAUGES is not None:
            # clear_registry() (tests) may have wiped the exposition
            # registry out from under the cache: rebuild so the suite
            # re-registers.
            sentinel = _GAUGES["nodes_alive"]
            with _metrics._REGISTRY_LOCK:
                live = _metrics._REGISTRY.get(sentinel.name) is sentinel
            if not live:
                _GAUGES = None
        if _GAUGES is None:
            _GAUGES = {
                "nodes_alive": Gauge(
                    "ray_tpu_nodes_alive", "Alive nodes in the cluster"
                ),
                "nodes_dead": Gauge(
                    "ray_tpu_nodes_dead", "Registered nodes now dead"
                ),
                "actors": Gauge(
                    "ray_tpu_actors", "Actors by state", tag_keys=("state",)
                ),
                "tasks": Gauge(
                    "ray_tpu_tasks", "Task events by state", tag_keys=("state",)
                ),
                "scheduler_queued": Gauge(
                    "ray_tpu_scheduler_queued_tasks",
                    "Tasks waiting in the scheduler queue",
                ),
                "scheduler_blocked": Gauge(
                    "ray_tpu_scheduler_blocked_shapes",
                    "Shape-classes parked as unplaceable",
                ),
                "object_store_used": Gauge(
                    "ray_tpu_object_store_used_bytes",
                    "In-process object store usage",
                ),
                "object_store_objects": Gauge(
                    "ray_tpu_object_store_objects",
                    "Objects tracked by the in-process store",
                ),
                "placement_groups": Gauge(
                    "ray_tpu_placement_groups",
                    "Placement groups by state",
                    tag_keys=("state",),
                ),
                "resources_total": Gauge(
                    "ray_tpu_resources_total",
                    "Cluster resource capacity",
                    tag_keys=("resource",),
                ),
                "resources_available": Gauge(
                    "ray_tpu_resources_available",
                    "Cluster resources currently free",
                    tag_keys=("resource",),
                ),
            }
    return _GAUGES


def _set_tagged(gauge, counts: dict, tag_key: str) -> None:
    """Set a tagged gauge from fresh counts, ZEROING series whose tag state
    vanished from the counts — without this, a state that empties (e.g.
    tasks:RUNNING after the last task finishes) freezes at its final
    nonzero value in every later sample and the history chart lies."""
    for tags, _old in gauge._series().items():
        value = dict(tags).get(tag_key)
        if value is not None and value not in counts:
            gauge.set(0.0, tags={tag_key: value})
    for state, count in counts.items():
        gauge.set(count, tags={tag_key: state})


def sample_runtime_metrics(runtime) -> None:
    """Refresh the standard gauge suite from the runtime's state tables."""
    g = _gauges()
    controller = runtime.controller
    nodes = list(controller.nodes.values())
    g["nodes_alive"].set(sum(1 for n in nodes if n.alive))
    g["nodes_dead"].set(sum(1 for n in nodes if not n.alive))

    actor_counts: dict = {}
    for record in controller.list_actors():
        state = record.state.value
        actor_counts[state] = actor_counts.get(state, 0) + 1
    _set_tagged(g["actors"], actor_counts, "state")

    task_counts: dict = {}
    for ev in runtime.task_events.list_events():
        task_counts[ev.state] = task_counts.get(ev.state, 0) + 1
    _set_tagged(g["tasks"], task_counts, "state")

    sched = runtime.scheduler
    with sched._cond:
        g["scheduler_queued"].set(len(sched._queue) + len(sched._in_pass))
        g["scheduler_blocked"].set(len(sched._blocked))

    store = runtime.store
    used = getattr(store, "used_bytes", 0)
    g["object_store_used"].set(float(used() if callable(used) else used))
    g["object_store_objects"].set(float(len(getattr(store, "_entries", ()))))

    pg_counts: dict = {}
    for record in controller.placement_groups.values():
        state = record.state.value
        pg_counts[state] = pg_counts.get(state, 0) + 1
    _set_tagged(g["placement_groups"], pg_counts, "state")

    total: dict = {}
    avail: dict = {}
    for node in nodes:
        if not node.alive:
            continue
        for key, value in node.total.items():
            total[key] = total.get(key, 0.0) + value
        for key, value in node.available.items():
            avail[key] = avail.get(key, 0.0) + value
    for key, value in total.items():
        g["resources_total"].set(value, tags={"resource": key})
    for key, value in avail.items():
        g["resources_available"].set(value, tags={"resource": key})


class RuntimeMetricsSampler:
    """Background refresher (the reporter-agent analog)."""

    def __init__(self, runtime, period_s: float = 5.0):
        self._runtime = runtime
        self._period = period_s
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="runtime-metrics", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._period):
            try:
                sample_runtime_metrics(self._runtime)
            except Exception:
                pass  # sampling must never hurt the runtime

    def stop(self) -> None:
        self._stop.set()


def list_llm_engine_actors(runtime) -> list:
    """Live named LLM engine actors (llm.serve names them
    "llm_engine:<name>"), as (name, namespace) pairs. The reference's
    scrape-time samplers beside it (`sample_llm_engine_metrics`,
    `sample_serve_metrics`, `MetricsHistory`) feed the dashboard and come
    with it (ROADMAP §B10)."""
    out = []
    for record in runtime.controller.list_actors():
        name = getattr(record, "name", None)
        if (
            name
            and name.startswith("llm_engine:")
            and record.state.value == "ALIVE"
        ):
            out.append((name, record.namespace))
    return out
