"""Per-subsystem runtime gauges — the standard metric suite.

Reference: src/ray/stats/metric_defs.h:46-88 (the canonical gauge set every
Ray process exports: scheduler/task-state counts, object store usage,
node/actor liveness) + the dashboard's reporter agent. Here one sampler
refreshes the suite from the runtime's state tables; `prometheus_text()`
(util/metrics.py) renders it alongside user-defined metrics, and the
dashboard's /metrics endpoint serves it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from ray_tpu_torch.util.metrics import Gauge

_GAUGES: Optional[dict] = None
_GAUGE_LOCK = threading.Lock()


class MetricsHistory:
    """Bounded in-head timeseries ring of the gauge suite.

    Every other dashboard endpoint is a now-snapshot; this ring answers
    "when did it change". One ring (default 720 samples ≈ 1h at the 5s
    sampler period): the in-head analog of the reference's
    Prometheus+Grafana retention
    (dashboard/modules/metrics/grafana_dashboard_factory.py intent)."""

    def __init__(self, max_samples: int = 720):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max_samples)

    def record(self) -> None:
        """Snapshot current gauge values (call after a sampler refresh)."""
        g = _gauges()
        values: dict[str, float] = {}
        for key, gauge in g.items():
            for tags, value in gauge._series().items():
                label = key
                if tags:
                    label += ":" + ",".join(str(v) for _, v in tags)
                values[label] = value
        with self._lock:
            self._ring.append((time.time(), values))

    def snapshot(self, limit: int = 720, since: float = 0.0) -> list[dict]:
        """Most-recent samples as [{"t": epoch_s, "v": {label: value}}]."""
        with self._lock:
            samples = list(self._ring)
        if since:
            samples = [s for s in samples if s[0] > since]
        return [{"t": t, "v": v} for t, v in samples[-limit:]]


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
                "shm_used": Gauge(
                    "ray_tpu_shm_store_used_bytes",
                    "Native shared-memory store usage",
                ),
                "shm_objects": Gauge(
                    "ray_tpu_shm_store_objects",
                    "Objects in the native shared-memory store",
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
    # The nodes that left count too (ROADMAP.md §D31); the reference's
    # table drops them, so its gauge stays 0.
    g["nodes_dead"].set(
        sum(1 for n in nodes if not n.alive) + len(controller.dead_nodes)
    )

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
    native = runtime._native_store
    if native is not None:
        try:
            g["shm_used"].set(float(native.used_bytes()))
            g["shm_objects"].set(float(native.num_objects()))
        except Exception:
            pass

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


def list_llm_engine_actors(runtime) -> list:
    """Live named LLM engine actors (llm.serve names them
    "llm_engine:<name>"), as (name, namespace) pairs."""
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


def sample_llm_engine_metrics(runtime, timeout_s: float = 2.0) -> None:
    """Scrape-time freshness for the LLM engine gauges: the engine only
    updates them when it steps, so an idle engine's queue-depth /
    cache-utilization / hit-rate series would otherwise freeze at their
    last-step values. Pulls LLMServer.metrics() from every live named
    engine actor and rewrites the engine-tagged series (stats carry the
    engine's own metric tag id), plus a dead-letter-count gauge. Failures
    are swallowed — a slow engine must never break the /metrics scrape."""
    from ray_tpu_torch.util.metrics import get_or_create

    engines = list_llm_engine_actors(runtime)
    if not engines:
        return
    import ray_tpu_torch

    gauges = {
        "queue_depth": get_or_create(
            Gauge,
            "llm_engine_queue_depth",
            "Requests waiting for a decode slot",
            tag_keys=("engine",),
        ),
        "cache_utilization": get_or_create(
            Gauge,
            "llm_engine_cache_utilization",
            "Allocated KV blocks / usable",
            tag_keys=("engine",),
        ),
        "prefix_cache_hit_rate": get_or_create(
            Gauge,
            "llm_engine_prefix_cache_hit_rate",
            "Cumulative prefix-cache hit tokens / prefill tokens",
            tag_keys=("engine",),
        ),
        "evictable_blocks": get_or_create(
            Gauge,
            "llm_engine_evictable_blocks",
            "Cached-but-unreferenced KV blocks (reusable until evicted)",
            tag_keys=("engine",),
        ),
        "spec_acceptance_rate": get_or_create(
            Gauge,
            "llm_engine_spec_acceptance_rate",
            "Cumulative accepted / proposed speculative tokens",
            tag_keys=("engine",),
        ),
        "prefill_backlog_tokens": get_or_create(
            Gauge,
            "llm_engine_prefill_backlog_tokens",
            "Prompt tokens admitted or queued but not yet fed through a "
            "prefill program (chunked prefill drains this at "
            "max_prefill_tokens_per_step per engine step)",
            tag_keys=("engine",),
        ),
        "fabric_hit_rate": get_or_create(
            Gauge,
            "llm_engine_fabric_hit_rate",
            "Cumulative fabric-restored tokens / prefill tokens",
            tag_keys=("engine",),
        ),
        # Overload-plane counters re-exported as scrape-time gauges: the
        # engine's own llm_engine_shed_requests / expired_requests /
        # fabric_timeouts Counters live in the engine's process, so a
        # process-isolated engine's totals would otherwise never reach
        # this head's /metrics exposition (distinct names — a Gauge may
        # not shadow a Counter already registered in-process).
        "shed_requests": get_or_create(
            Gauge,
            "llm_engine_overload_sheds",
            "Cumulative submissions rejected by bounded admission or dead "
            "on arrival (engine stats total)",
            tag_keys=("engine",),
        ),
        "expired_requests": get_or_create(
            Gauge,
            "llm_engine_deadline_expiries",
            "Cumulative in-flight requests expired past their deadline "
            "(engine stats total)",
            tag_keys=("engine",),
        ),
        "fabric_timeouts": get_or_create(
            Gauge,
            "llm_engine_fabric_timeouts_total",
            "Cumulative KV-fabric restore timeouts (engine stats total)",
            tag_keys=("engine",),
        ),
    }
    fabric_bytes = get_or_create(
        Gauge,
        "llm_engine_fabric_bytes_used",
        "Bytes resident in the engine's KV fabric store",
        tag_keys=("engine",),
    )
    dead_letters = get_or_create(
        Gauge,
        "llm_engine_dead_letters",
        "Dead-letter records currently retained by the engine",
        tag_keys=("engine",),
    )
    wedged = get_or_create(
        Gauge,
        "llm_engine_wedged",
        "1 when the engine declared itself wedged",
        tag_keys=("engine",),
    )
    # Fire every engine's RPC first, then collect against ONE shared
    # deadline: a slow/wedged engine costs the scrape at most timeout_s
    # total, not timeout_s per engine.
    pending = []
    for name, namespace in engines:
        try:
            handle = ray_tpu_torch.get_actor(name, namespace=namespace)
            pending.append((name, handle.metrics.remote()))
        except Exception:
            continue
    deadline = time.monotonic() + timeout_s
    for name, ref in pending:
        try:
            stats = ray_tpu_torch.get(
                ref, timeout=max(deadline - time.monotonic(), 0.05)
            )
            tags = {"engine": stats.get("engine_id") or name}
            for key, gauge in gauges.items():
                if key not in stats:
                    continue
                if (
                    key == "spec_acceptance_rate"
                    and stats.get("speculation", "off") == "off"
                ):
                    # stats() always carries the field (0.0 when
                    # speculation is off); exporting it for
                    # non-speculating engines would make "disabled"
                    # indistinguishable from "0% acceptance" — mirror
                    # the engine, which only registers spec series when
                    # a proposer is configured.
                    continue
                if (
                    key == "fabric_hit_rate"
                    and stats.get("kv_fabric", "off") == "off"
                ):
                    # Same disabled-vs-zero distinction as speculation:
                    # the engine only registers fabric series when a
                    # kv_fabric is configured.
                    continue
                gauge.set(float(stats[key]), tags=tags)
            fabric_store = stats.get("fabric_store")
            if stats.get("kv_fabric", "off") != "off" and isinstance(
                fabric_store, dict
            ):
                fabric_bytes.set(
                    float(fabric_store.get("bytes_used", 0)), tags=tags
                )
            dead_letters.set(float(stats.get("num_dead_letters", 0)), tags=tags)
            wedged.set(1.0 if stats.get("wedged") else 0.0, tags=tags)
        except Exception:
            continue


def sample_serve_metrics(runtime, timeout_s: float = 2.0) -> None:
    """Scrape-time freshness for the Serve control-plane gauges: replica
    lifecycle-state counts per deployment
    (serve_deployment_replica_state{app,deployment,state}) from the
    controller's observability snapshot. Every known state is written on
    every scrape — including zeros — so a state that empties (the last
    DRAINING replica stopping) never freezes at its final nonzero value.
    Failures are swallowed: a busy controller must never break /metrics."""
    from ray_tpu_torch.serve._private.controller import (
        CONTROLLER_NAME,
        REPLICA_STATES,
    )
    from ray_tpu_torch.util.metrics import get_or_create

    existing = runtime.controller.get_named_actor(
        CONTROLLER_NAME, runtime.namespace
    )
    if existing is None:
        return
    import ray_tpu_torch
    from ray_tpu_torch.actor import ActorHandle

    try:
        obs = ray_tpu_torch.get(
            ActorHandle(
                existing, "ServeControllerActor"
            ).get_observability.remote(),
            timeout=timeout_s,
        )
    except Exception:
        return
    state_gauge = get_or_create(
        Gauge,
        "serve_deployment_replica_state",
        "Replicas per lifecycle state (STARTING/RUNNING/DRAINING; STOPPED "
        "replicas leave the set, so its series reads 0)",
        tag_keys=("app", "deployment", "state"),
    )
    seen = set()
    for app_name, deps in obs.items():
        for dep_name, dep in deps.items():
            counts = dep.get("state_counts", {})
            for state in REPLICA_STATES:
                tags = {
                    "app": app_name, "deployment": dep_name, "state": state,
                }
                state_gauge.set(float(counts.get(state, 0)), tags=tags)
                seen.add((app_name, dep_name, state))
    # Deployments deleted since the last scrape: zero their series so the
    # history chart doesn't carry ghost replicas.
    for tags, _old in state_gauge._series().items():
        td = dict(tags)
        key = (td.get("app"), td.get("deployment"), td.get("state"))
        if all(key) and key not in seen:
            state_gauge.set(
                0.0,
                tags={"app": key[0], "deployment": key[1], "state": key[2]},
            )


class RuntimeMetricsSampler:
    """Background refresher (the reporter-agent analog)."""

    def __init__(self, runtime, period_s: float = 5.0):
        self._runtime = runtime
        self._period = period_s
        self._stop = threading.Event()
        self.history = MetricsHistory()
        self._thread = threading.Thread(
            target=self._loop, name="runtime-metrics", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._period):
            try:
                sample_runtime_metrics(self._runtime)
                self.history.record()
            except Exception:
                pass  # sampling must never hurt the runtime

    def stop(self) -> None:
        self._stop.set()
