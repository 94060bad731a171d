"""Fleet collector — one periodic pass that merges every engine
replica's observability snapshot into a single fleet view.

Each LLM engine actor already exposes `observability_snapshot()` —
metrics + shed ring + flight-record ring + engine-side histogram
snapshots in ONE actor round trip. The collector fires that RPC at
every live `llm_engine:*` actor, collects against one shared deadline
(the /metrics scrape idiom from util/runtime_metrics — a wedged replica
costs one timeout total, not one per replica), then:

- builds a per-replica time ledger from each flight ring
  (ledger.replica_ledger) and merges them (ledger.fleet_ledger);
- diff-merges the per-replica `llm_request_*` histogram snapshots into
  fleet histograms via util.metrics.merge_snapshots (typed error on
  ladder mismatch — never silently mis-sums);
- computes fleet latency percentiles from the merged buckets.

`fleet_snapshot()` is the pull API; `FleetCollector` is the optional
background refresher that keeps the latest snapshot for cheap reads. The
dashboard serves it at `/api/fleet`, and the CLI's `top` prints it.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ray_tpu_torch.observability import ledger as _ledger
from ray_tpu_torch.util.metrics import (
    BucketMismatchError,
    merge_snapshots,
    percentile_from_buckets,
)

# Request-latency histograms merged fleet-wide (matching the keys the
# engine ships in observability_snapshot()["histograms"]).
FLEET_HISTOGRAMS = (
    "llm_request_ttft_seconds",
    "llm_request_time_per_output_token_seconds",
    "llm_request_queue_time_seconds",
    "llm_request_e2e_seconds",
    "llm_engine_step_host_gap_seconds",
)


def fleet_snapshot(
    runtime=None,
    steps_limit: Optional[int] = 512,
    timeout_s: float = 2.0,
    peak_flops_per_s: Optional[float] = None,
) -> dict:
    """One fleet view: per-replica time ledgers + merged ledger + merged
    request histograms + percentiles. Degrades per replica — a replica
    that times out appears with an "error" field instead of failing the
    whole snapshot."""
    if runtime is None:
        from ray_tpu_torch._private.runtime import get_runtime

        runtime = get_runtime()
    from ray_tpu_torch.util.runtime_metrics import list_llm_engine_actors

    import ray_tpu_torch

    engines = list_llm_engine_actors(runtime)
    pending = []
    for name, namespace in engines:
        try:
            handle = ray_tpu_torch.get_actor(name, namespace=namespace)
            pending.append(
                (name, handle.observability_snapshot.remote(steps_limit))
            )
        except Exception:
            continue

    replicas: dict = {}
    ledgers: dict = {}
    histograms: dict = {name: [] for name in FLEET_HISTOGRAMS}
    deadline = time.monotonic() + timeout_s
    for name, ref in pending:
        try:
            snap = ray_tpu_torch.get(
                ref, timeout=max(deadline - time.monotonic(), 0.05)
            )
        except Exception as exc:
            replicas[name] = {"error": repr(exc)}
            continue
        stats = snap.get("metrics") or {}
        steps = (snap.get("flight_record") or {}).get("steps") or []
        replica = _ledger.replica_ledger(
            steps,
            model_params=stats.get("model_params"),
            peak_flops_per_s=peak_flops_per_s,
        )
        ledgers[name] = replica
        replicas[name] = {
            "ledger": replica,
            "engine_id": stats.get("engine_id"),
            "wedged": bool(stats.get("wedged")),
            "queue_depth": stats.get("queue_depth"),
            "shed_requests": stats.get("shed_requests"),
            "expired_requests": stats.get("expired_requests"),
            "fabric_timeouts": stats.get("fabric_timeouts"),
            "model_params": stats.get("model_params"),
        }
        for metric, snapshot in (snap.get("histograms") or {}).items():
            if metric in histograms and snapshot:
                histograms[metric].append(snapshot)

    merged: dict = {}
    percentiles: dict = {}
    for metric, snaps in histograms.items():
        if not snaps:
            continue
        try:
            merged[metric] = merge_snapshots(snaps)
        except BucketMismatchError as exc:
            # Replicas disagree on the bucket ladder (mixed versions):
            # surface the mismatch instead of a silently-wrong sum.
            merged[metric] = {"error": repr(exc)}
            continue
        m = merged[metric]
        if m["count"]:
            percentiles[metric] = {
                "p50": percentile_from_buckets(
                    m["boundaries"], m["buckets"], 50.0
                ),
                "p99": percentile_from_buckets(
                    m["boundaries"], m["buckets"], 99.0
                ),
                "count": m["count"],
            }

    return {
        "time": time.time(),
        "replicas": replicas,
        "fleet": _ledger.fleet_ledger(ledgers),
        "histograms": merged,
        "percentiles": percentiles,
    }


class FleetCollector:
    """Background refresher: re-scrapes the fleet every `period_s` and
    keeps the latest snapshot for cheap reads (a reader takes it instead
    of fanning out to every engine per request)."""

    def __init__(
        self,
        runtime,
        period_s: float = 5.0,
        steps_limit: Optional[int] = 512,
        timeout_s: float = 2.0,
    ):
        self._runtime = runtime
        self._period = period_s
        self._steps_limit = steps_limit
        self._timeout_s = timeout_s
        self._lock = threading.Lock()
        self._latest: Optional[dict] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="fleet-collector", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._period):
            try:
                snap = fleet_snapshot(
                    self._runtime,
                    steps_limit=self._steps_limit,
                    timeout_s=self._timeout_s,
                )
                with self._lock:
                    self._latest = snap
            except Exception:
                pass  # collection must never hurt the runtime

    def latest(self, max_age_s: Optional[float] = None) -> Optional[dict]:
        with self._lock:
            snap = self._latest
        if (
            snap is not None
            and max_age_s is not None
            and time.time() - snap["time"] > max_age_s
        ):
            return None
        return snap

    def stop(self) -> None:
        self._stop.set()
