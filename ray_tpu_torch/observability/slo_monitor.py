"""Continuous SLO burn-rate monitor over the live request histograms.

Burn rate is the standard SRE alerting signal: for an SLO rule
"metric_pN < T seconds", the error budget is the fraction of requests
allowed over T — (100−N)/100. The burn rate of a window is

    (fraction of the window's samples over T) / error budget

so 1.0 means "consuming budget exactly as fast as the SLO allows",
above 1.0 means the SLO will be violated if the window's behavior
holds. Multi-window evaluation (default 5s and 60s) is what makes it an
alerting signal rather than a noisy spot check: the short window fires
fast on a burst, the long window filters transients.

The monitor samples the cumulative `llm_request_*` histograms (engine
counters only ever grow), keeps a timestamped ring of snapshots, and
computes each window's burn from the bucket-count *diff* between now
and the window's start — `util.metrics.fraction_over_threshold` turns
the diffed buckets into a violation fraction with linear interpolation
inside the threshold's bucket. Burns are exported as
`llm_slo_burn_rate{window, slo}` gauges (max across the spec's rules)
and fed to the serve autoscaler via `autoscaler_signal()`
(`LLMAutoscalingPolicy.target_burn_rate`).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Sequence, Tuple

from ray_tpu_torch.loadgen.slo import SLOSpec
from ray_tpu_torch.util.metrics import (
    Gauge,
    Histogram,
    _REGISTRY,
    _REGISTRY_LOCK,
    fraction_over_threshold,
    get_or_create,
    merge_snapshots,
)

# SLO rule metric → the request histogram it is measured against.
SLO_METRIC_HISTOGRAMS = {
    "ttft": "llm_request_ttft_seconds",
    "tpot": "llm_request_time_per_output_token_seconds",
    "e2e": "llm_request_e2e_seconds",
}


def registry_histogram_snapshot(name: str) -> Optional[dict]:
    """Snapshot a registered histogram summed across ALL its series
    (every engine tag) — the monitor watches the process-wide request
    population, not one engine's. None when the metric has not
    registered yet (no engine has served a request)."""
    with _REGISTRY_LOCK:
        metric = _REGISTRY.get(name)
    if metric is None or not isinstance(metric, Histogram):
        return None
    series = metric._series()
    if not series:
        return {
            "boundaries": list(metric.boundaries),
            "buckets": [0] * (len(metric.boundaries) + 1),
            "sum": 0.0,
            "count": 0,
        }
    return merge_snapshots(
        [
            {
                "boundaries": list(metric.boundaries),
                "buckets": data["buckets"],
                "sum": data["sum"],
                "count": data["count"],
            }
            for data in series.values()
        ]
    )


def _default_source() -> Dict[str, dict]:
    out = {}
    for hist_name in set(SLO_METRIC_HISTOGRAMS.values()):
        snap = registry_histogram_snapshot(hist_name)
        if snap is not None:
            out[hist_name] = snap
    return out


def _window_label(seconds: float) -> str:
    return f"{seconds:g}s"


class SLOBurnRateMonitor:
    """Multi-window burn-rate evaluation of one `SLOSpec`.

    `source` is injectable for tests and for remote-fed snapshots (e.g.
    feeding merged fleet histograms from the collector); the default
    reads the local metrics registry, which is shared in-process with
    thread-isolated engine actors.
    """

    def __init__(
        self,
        spec: SLOSpec,
        windows: Sequence[float] = (5.0, 60.0),
        source: Optional[Callable[[], Dict[str, dict]]] = None,
        gauge: bool = True,
    ):
        if not windows:
            raise ValueError("need at least one burn-rate window")
        self._spec = spec
        self._windows = tuple(sorted(float(w) for w in windows))
        self._source = source or _default_source
        self._ring: deque = deque()
        self._lock = threading.Lock()
        self._latest: Dict[str, Dict[str, float]] = {}
        self._peak: Dict[str, float] = {}
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._gauge = (
            get_or_create(
                Gauge,
                "llm_slo_burn_rate",
                "SLO error-budget burn rate per evaluation window "
                "(>1.0 = violating; max across the spec's rules)",
                tag_keys=("window", "slo"),
            )
            if gauge
            else None
        )

    @property
    def spec(self) -> SLOSpec:
        return self._spec

    @property
    def windows(self) -> Tuple[float, ...]:
        return self._windows

    def sample(self, now: Optional[float] = None) -> Dict[str, float]:
        """Take one snapshot, evaluate every window against it, update
        the gauges. Returns {window_label: burn} (max across rules; 0.0
        when a window saw no samples — no traffic burns no budget)."""
        if now is None:
            now = time.monotonic()
        snap = self._source()
        with self._lock:
            self._ring.append((now, snap))
            horizon = now - self._windows[-1] - 1.0
            # Keep one sample at-or-before the horizon so the longest
            # window always has a baseline to diff against.
            while len(self._ring) >= 2 and self._ring[1][0] <= horizon:
                self._ring.popleft()
            ring = list(self._ring)

        burns: Dict[str, float] = {}
        detail: Dict[str, Dict[str, float]] = {}
        for window in self._windows:
            label = _window_label(window)
            base = self._baseline(ring, now - window)
            rule_burns = self._evaluate(base, snap)
            detail[label] = rule_burns
            burns[label] = max(rule_burns.values()) if rule_burns else 0.0
        with self._lock:
            self._latest = detail
            for label, burn in burns.items():
                if burn > self._peak.get(label, 0.0):
                    self._peak[label] = burn
        if self._gauge is not None:
            for label, burn in burns.items():
                self._gauge.set(
                    burn, tags={"window": label, "slo": self._spec.name}
                )
        return burns

    @staticmethod
    def _baseline(ring, start_t: float) -> Optional[Dict[str, dict]]:
        """Latest snapshot taken at-or-before the window start (so the
        diff covers the whole window); the oldest one when the monitor
        is younger than the window."""
        base = None
        for t, snap in ring:
            if t <= start_t:
                base = snap
            else:
                break
        if base is None and ring:
            base = ring[0][1]
        return base

    def _evaluate(
        self,
        base: Optional[Dict[str, dict]],
        current: Dict[str, dict],
    ) -> Dict[str, float]:
        burns: Dict[str, float] = {}
        for rule in self._spec.rules:
            hist_name = SLO_METRIC_HISTOGRAMS.get(rule.metric)
            if hist_name is None:
                continue
            cur = current.get(hist_name)
            if cur is None:
                continue
            buckets = list(cur["buckets"])
            old = (base or {}).get(hist_name)
            if old is not None and old is not cur:
                if list(old["boundaries"]) == list(cur["boundaries"]):
                    buckets = [
                        max(c - o, 0)
                        for c, o in zip(buckets, old["buckets"])
                    ]
            fraction = fraction_over_threshold(
                cur["boundaries"], buckets, rule.max_seconds
            )
            if fraction is None:
                burns[rule.label] = 0.0
                continue
            budget = max((100.0 - rule.percentile) / 100.0, 1e-9)
            burns[rule.label] = fraction / budget
        return burns

    def burn_rates(self) -> Dict[str, Dict[str, float]]:
        """Last evaluation, per window per rule label."""
        with self._lock:
            return {w: dict(r) for w, r in self._latest.items()}

    def peak_burn(self, window: Optional[float] = None) -> float:
        """Highest burn seen since construction (sweep gates record
        this): for one window, or the max across windows."""
        with self._lock:
            if window is not None:
                return self._peak.get(_window_label(window), 0.0)
            return max(self._peak.values()) if self._peak else 0.0

    def autoscaler_signal(self) -> Dict[str, float]:
        """The scaling signal (`LLMAutoscalingPolicy.target_burn_rate`
        consumes `signals["slo_burn_rate"]`): the SHORTEST window's
        latest burn — upscale must react to the burst, not wait out the
        long window."""
        label = _window_label(self._windows[0])
        with self._lock:
            rules = self._latest.get(label, {})
        return {"slo_burn_rate": max(rules.values()) if rules else 0.0}

    def start(self, interval_s: float = 1.0) -> "SLOBurnRateMonitor":
        """Background sampling loop (daemon thread); idempotent."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop = threading.Event()

        def _loop():
            while not self._stop.wait(interval_s):
                try:
                    self.sample()
                except Exception:
                    pass  # monitoring must never hurt the serving path

        self._thread = threading.Thread(
            target=_loop, name="slo-burn-monitor", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
