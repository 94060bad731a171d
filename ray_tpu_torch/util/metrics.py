"""Application metrics: Counter / Gauge / Histogram + Prometheus exposition.

The serving engine's and Serve's part of the reference package's metrics
module: metrics write to one in-process registry and `prometheus_text()`
renders the standard text exposition format.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

_REGISTRY_LOCK = threading.Lock()
_REGISTRY: Dict[str, "Metric"] = {}
# Bumped by reset_registry(); metrics re-register lazily on their next write
# when their registration generation is stale (see Metric._ensure_registered).
_REGISTRY_GEN = 0

DEFAULT_HISTOGRAM_BOUNDARIES = [
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0,
]


def _tag_key(tags: Optional[dict]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((tags or {}).items()))


class Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str = "", tag_keys: Sequence[str] = ()):
        if not name or not name.replace("_", "").replace(":", "").isalnum():
            raise ValueError(f"Invalid metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._lock = threading.Lock()
        with _REGISTRY_LOCK:
            existing = _REGISTRY.get(name)
            if existing is not None and existing.kind != self.kind:
                raise ValueError(
                    f"Metric {name!r} already registered as {existing.kind}"
                )
            _REGISTRY[name] = self
            self._reg_gen = _REGISTRY_GEN

    def _ensure_registered(self) -> None:
        """Re-register after reset_registry() wiped the exposition table, so
        long-lived holders (an engine that outlives a test's reset) keep
        exporting on their next write. First writer wins: if a FRESH metric
        of this name registered since the reset (the common get_or_create
        path in a new test), it keeps the name and this instance's writes
        simply stop being exported — series never flip-flop between
        instances. One int compare on the hot path."""
        if self._reg_gen == _REGISTRY_GEN:
            return
        with _REGISTRY_LOCK:
            _REGISTRY.setdefault(self.name, self)
            self._reg_gen = _REGISTRY_GEN

    def _merged(self, tags: Optional[dict]) -> Tuple[Tuple[str, str], ...]:
        if tags and self.tag_keys:
            unknown = set(tags) - set(self.tag_keys)
            if unknown:
                raise ValueError(f"Unknown tag keys {unknown} for {self.name}")
        return _tag_key(tags)

    def _series(self) -> dict:
        raise NotImplementedError


class Counter(Metric):
    kind = "counter"

    def __init__(self, name, description: str = "", tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[tuple, float] = {}

    def inc(self, value: float = 1.0, tags: Optional[dict] = None) -> None:
        if value < 0:
            raise ValueError("Counters only increase")
        self._ensure_registered()
        key = self._merged(tags)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def _series(self) -> dict:
        with self._lock:
            return dict(self._values)


class Gauge(Metric):
    kind = "gauge"

    def __init__(self, name, description: str = "", tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self._values: Dict[tuple, float] = {}

    def set(self, value: float, tags: Optional[dict] = None) -> None:
        self._ensure_registered()
        with self._lock:
            self._values[self._merged(tags)] = float(value)

    def _series(self) -> dict:
        with self._lock:
            return dict(self._values)


class Histogram(Metric):
    kind = "histogram"

    def __init__(
        self,
        name,
        description: str = "",
        boundaries: Optional[Sequence[float]] = None,
        tag_keys: Sequence[str] = (),
    ):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries or DEFAULT_HISTOGRAM_BOUNDARIES)
        self._buckets: Dict[tuple, List[int]] = {}
        self._sums: Dict[tuple, float] = {}
        self._counts: Dict[tuple, int] = {}

    def observe(self, value: float, tags: Optional[dict] = None) -> None:
        self._ensure_registered()
        key = self._merged(tags)
        with self._lock:
            buckets = self._buckets.setdefault(
                key, [0] * (len(self.boundaries) + 1)
            )
            # bisect_left: Prometheus `le` is inclusive, so a value equal to
            # a boundary belongs in that boundary's bucket.
            buckets[bisect_left(self.boundaries, value)] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._counts[key] = self._counts.get(key, 0) + 1

    def _series(self) -> dict:
        with self._lock:
            return {
                key: {
                    "buckets": list(self._buckets[key]),
                    "sum": self._sums[key],
                    "count": self._counts[key],
                }
                for key in self._buckets
            }

    def snapshot(self, tags: Optional[dict] = None) -> dict:
        """Bucket counts / sum / count for ONE series of this histogram
        (zeros when the series has not observed yet). Instance-level
        sibling of the registry-keyed `histogram_snapshot` below — holders
        of the metric object (e.g. the LLM engine shipping its SLO
        histogram windows to the autoscaler) snapshot without a registry
        lookup, so a test's reset_registry can never make them miss."""
        key = self._merged(tags)
        with self._lock:
            return {
                "boundaries": list(self.boundaries),
                "buckets": list(
                    self._buckets.get(key, [0] * (len(self.boundaries) + 1))
                ),
                "sum": self._sums.get(key, 0.0),
                "count": self._counts.get(key, 0),
            }


def _escape_label(value: str) -> str:
    """Prometheus exposition label escaping: backslash, quote, newline."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_tags(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in key)
    return "{" + inner + "}"


def prometheus_text() -> str:
    """Render every registered metric in Prometheus text exposition format."""
    lines: List[str] = []
    with _REGISTRY_LOCK:
        metrics = list(_REGISTRY.values())
    for m in metrics:
        lines.append(f"# HELP {m.name} {m.description}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        series = m._series()
        if isinstance(m, Histogram):
            for key, data in series.items():
                cumulative = 0
                for bound, n in zip(m.boundaries, data["buckets"]):
                    cumulative += n
                    tag = dict(key)
                    tag["le"] = repr(bound)
                    lines.append(
                        f"{m.name}_bucket{_fmt_tags(_tag_key(tag))} {cumulative}"
                    )
                tag = dict(key)
                tag["le"] = "+Inf"
                lines.append(
                    f"{m.name}_bucket{_fmt_tags(_tag_key(tag))} {data['count']}"
                )
                lines.append(f"{m.name}_sum{_fmt_tags(key)} {data['sum']}")
                lines.append(f"{m.name}_count{_fmt_tags(key)} {data['count']}")
        else:
            for key, value in series.items():
                lines.append(f"{m.name}{_fmt_tags(key)} {value}")
    return "\n".join(lines) + "\n"


def percentile_from_buckets(
    boundaries: Sequence[float], buckets: Sequence[int], q: float
) -> Optional[float]:
    """q-th percentile (q in [0, 100]) from histogram bucket counts, with
    linear interpolation inside the containing bucket (the decade-ladder
    boundaries are coarse, so nearest-rank alone would quantize every
    percentile to a bucket edge). `buckets` has len(boundaries) + 1 counts;
    the final count is the overflow (+Inf) bucket. Following the Prometheus
    histogram_quantile convention, a percentile landing in the overflow
    bucket returns the highest finite boundary — there is no upper edge to
    interpolate toward. Returns None when the series has no samples."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile must be in [0, 100], got {q}")
    if len(buckets) != len(boundaries) + 1:
        raise ValueError(
            f"expected {len(boundaries) + 1} bucket counts for "
            f"{len(boundaries)} boundaries, got {len(buckets)}"
        )
    total = sum(buckets)
    if total <= 0:
        return None
    rank = (q / 100.0) * total
    cum = 0
    for i, n in enumerate(buckets[:-1]):
        if n and cum + n >= rank:
            lo = 0.0 if i == 0 else boundaries[i - 1]
            hi = boundaries[i]
            fraction = min(max((rank - cum) / n, 0.0), 1.0)
            return lo + fraction * (hi - lo)
        cum += n
    return float(boundaries[-1])  # overflow bucket: clamp (Prometheus)


class BucketMismatchError(ValueError):
    """Two histogram snapshots with different bucket ladders were asked to
    merge. Summing counts bucket-by-bucket across mismatched boundaries
    silently attributes samples to the wrong latency range — the fleet
    aggregator must refuse instead of mis-summing."""


def merge_snapshots(snapshots: Sequence[dict]) -> dict:
    """Sum histogram snapshots (`Histogram.snapshot` /
    `histogram_snapshot` shape: {"boundaries", "buckets", "sum",
    "count"}) into one — the cross-replica aggregation primitive: every
    engine exports the same ladders (the module-level boundary constants),
    so bucket-wise addition is exact, and percentiles of the merged
    snapshot are fleet percentiles. Raises BucketMismatchError when any
    two ladders differ (never mis-sums), ValueError on an empty input."""
    if not snapshots:
        raise ValueError("merge_snapshots needs at least one snapshot")
    base = snapshots[0]
    boundaries = list(base["boundaries"])
    buckets = [0] * (len(boundaries) + 1)
    total_sum = 0.0
    total_count = 0
    for snap in snapshots:
        if list(snap["boundaries"]) != boundaries:
            raise BucketMismatchError(
                f"cannot merge histogram snapshots with mismatched bucket "
                f"ladders: {boundaries} vs {list(snap['boundaries'])}"
            )
        counts = snap["buckets"]
        if len(counts) != len(boundaries) + 1:
            raise BucketMismatchError(
                f"expected {len(boundaries) + 1} bucket counts for "
                f"{len(boundaries)} boundaries, got {len(counts)}"
            )
        for i, n in enumerate(counts):
            buckets[i] += n
        total_sum += snap["sum"]
        total_count += snap["count"]
    return {
        "boundaries": boundaries,
        "buckets": buckets,
        "sum": total_sum,
        "count": total_count,
    }


def fraction_over_threshold(
    boundaries: Sequence[float], buckets: Sequence[int], threshold: float
) -> Optional[float]:
    """Fraction of observed samples strictly above `threshold`, linearly
    interpolated within the bucket containing it (the inverse read of
    percentile_from_buckets — the SLO burn-rate monitor's primitive: a
    rule `ttft_p99 < T` is burning when more than 1% of the window's
    samples land above T). Returns None when the series has no samples."""
    if len(buckets) != len(boundaries) + 1:
        raise ValueError(
            f"expected {len(boundaries) + 1} bucket counts for "
            f"{len(boundaries)} boundaries, got {len(buckets)}"
        )
    total = sum(buckets)
    if total <= 0:
        return None
    idx = bisect_left(boundaries, threshold)
    over = sum(buckets[idx + 1 :])
    # Split the containing bucket at the threshold (uniform-within-bucket,
    # matching percentile_from_buckets). The overflow bucket has no upper
    # edge: everything in it counts as over unless threshold is past the
    # last finite boundary, where interpolation is impossible — count it
    # all as over (conservative: alerts fire rather than stay silent).
    if idx < len(boundaries):
        lo = 0.0 if idx == 0 else boundaries[idx - 1]
        hi = boundaries[idx]
        inside = buckets[idx]
        fraction_above = (hi - threshold) / (hi - lo) if hi > lo else 0.0
        over += inside * min(max(fraction_above, 0.0), 1.0)
    else:
        over += buckets[-1]
    return over / total


def histogram_snapshot(name: str, tags: Optional[dict] = None) -> dict:
    """Bucket counts / sum / count for ONE series of a registered
    histogram: {"boundaries", "buckets", "sum", "count"} (zeros when the
    series has not been observed yet). The loadgen report diffs two
    snapshots to percentile just one run's window out of a long-lived
    engine's cumulative histogram."""
    with _REGISTRY_LOCK:
        m = _REGISTRY.get(name)
    if m is None:
        raise KeyError(f"no metric named {name!r} is registered")
    if not isinstance(m, Histogram):
        raise TypeError(f"metric {name!r} is a {m.kind}, not a histogram")
    return m.snapshot(tags)


def histogram_percentile(
    name: str, q: float, tags: Optional[dict] = None
) -> Optional[float]:
    """q-th percentile (q in [0, 100]) of one series of a registered
    histogram, linearly interpolated within its decade-ladder buckets (see
    percentile_from_buckets). The SLO gate and the dashboard both read
    p50/p99 from the existing llm_request_* histograms through this.
    Returns None when the series has no samples."""
    snap = histogram_snapshot(name, tags)
    return percentile_from_buckets(snap["boundaries"], snap["buckets"], q)


def bucket_index(boundaries: Sequence[float], value: float) -> int:
    """Which bucket of `boundaries` a value falls in (last index = the
    overflow bucket) — mirrors Histogram.observe's inclusive-`le`
    placement. Two latency estimates "agree within one bucket" when their
    indices differ by at most 1 (the cross-check contract between
    loadgen-side samples and engine-side histogram percentiles).
    `boundaries` must be ascending, as Histogram already guarantees."""
    return bisect_left(boundaries, value)


def get_or_create(kind_cls, name: str, description: str = "", **kwargs):
    """Return the already-registered metric of this name/kind, or create it.

    Constructing a Metric always (re)binds the registry entry, so components
    that may be instantiated several times per process (e.g. one engine per
    Serve app) must share one instance — otherwise the newest instance
    silently evicts the older ones' series from the exposition. Distinguish
    instances with tags, not with separate metric objects."""
    with _REGISTRY_LOCK:
        existing = _REGISTRY.get(name)
    if existing is not None and isinstance(existing, kind_cls):
        return existing
    return kind_cls(name, description, **kwargs)


def reset_registry() -> None:
    """Drop every registered metric — test isolation between tests that
    construct multiple engines/routers in one process, so histogram
    tag-sets and counter values don't bleed from one test's exposition
    into the next. Surviving metric INSTANCES keep working: the first one
    to write after a reset re-registers itself (Metric._ensure_registered),
    while get_or_create() in later code sees an empty slot and builds a
    fresh zero-valued metric."""
    global _REGISTRY_GEN
    with _REGISTRY_LOCK:
        _REGISTRY.clear()
        _REGISTRY_GEN += 1

