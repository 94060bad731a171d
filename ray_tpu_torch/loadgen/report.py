"""Load-run reports: percentiles, error accounting, engine cross-check.

`build_report` turns a `LoadRunResult` into the per-cell record the
sweep stores: latency percentiles over the right sample populations,
offered vs achieved rate, and error/disconnect counts.

Sample populations (the SLO contract):
  * TTFT — every request that received a first token (completed AND
    disconnected: a client that walked away mid-stream still measured a
    real first-token latency);
  * TPOT / e2e — completed requests only;
  * errored requests (dead-lettered poison, timeouts, engine failures)
    are never latency samples — they are counted in `errors` by class
    and in `error_rate`.

`engine_window` / `engine_percentiles` / `cross_check` close the loop
against the engine's own `llm_request_*` histograms: the engine and the
loadgen measure the same requests from opposite ends of the serving
path, so their percentiles must agree within one decade-ladder bucket —
if they don't, one side's clock or sample population is lying, and the
bench record is invalid. Snapshots are diffed (cumulative histogram
before/after the run) so a long-lived engine's earlier traffic can't
leak into the window.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from ray_tpu_torch.loadgen.driver import LoadRunResult
from ray_tpu_torch.util.metrics import (
    bucket_index,
    histogram_snapshot,
    percentile_from_buckets,
)

DEFAULT_PERCENTILES = (50.0, 90.0, 95.0, 99.0)

# Loadgen-side metric -> the engine histogram measuring the same thing.
# queue_s has no client-side twin (an open-loop client cannot observe
# queue placement) — it is reported from the engine window only.
ENGINE_HISTOGRAMS = {
    "ttft_s": "llm_request_ttft_seconds",
    "tpot_s": "llm_request_time_per_output_token_seconds",
    "e2e_s": "llm_request_e2e_seconds",
    "queue_s": "llm_request_queue_time_seconds",
}

# Error classes carrying this marker are overload SHEDS — the control
# plane working as designed, not the server failing. They are counted in
# their own bucket (shed_rate) and excluded from failure_rate: a collapse
# gate must be able to demand "zero failures" while sheds are expected.
# Substring match, not equality: a shed raised inside an actor crosses
# the object store as the dynamic TaskError-derived class
# "TaskError(EngineOverloadedError)", and the driver records
# type(exc).__name__ verbatim.
SHED_ERROR_MARKER = "OverloadedError"


def is_shed_error(error: Optional[str]) -> bool:
    """Is this recorded error class an overload shed (vs a failure)?"""
    return error is not None and SHED_ERROR_MARKER in error


def percentile(samples: Sequence[float], q: float) -> Optional[float]:
    """q-th percentile (q in [0, 100]) with linear interpolation between
    order statistics (numpy's default "linear" method, dependency-free)."""
    if not samples:
        return None
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile must be in [0, 100], got {q}")
    ordered = sorted(samples)
    if len(ordered) == 1:
        return float(ordered[0])
    pos = (q / 100.0) * (len(ordered) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(ordered) - 1)
    frac = pos - lo
    return float(ordered[lo] + frac * (ordered[hi] - ordered[lo]))


def pct_key(q: float) -> str:
    """Canonical percentile key ("p50", "p99", "p99.9") — the ONE place
    the formatting lives: build_report emits these keys and
    slo.evaluate_slo looks them up, so they must never drift apart."""
    return f"p{int(q) if q == int(q) else q}"


def build_report(
    result: LoadRunResult, qs: Sequence[float] = DEFAULT_PERCENTILES
) -> dict:
    """The per-cell record: counts, rates, and latency percentiles."""
    completed = result.completed
    disconnected = [s for s in result.samples if s.disconnected]
    errored = [s for s in result.samples if s.error is not None]
    errors: Dict[str, int] = {}
    for s in errored:
        errors[s.error] = errors.get(s.error, 0) + 1
    shed = [s for s in errored if is_shed_error(s.error)]
    failed = [s for s in errored if not is_shed_error(s.error)]
    shed_latencies = [
        s.error_latency_s for s in shed if s.error_latency_s is not None
    ]
    populations = {
        "ttft_s": [
            s.ttft_s
            for s in result.samples
            if s.error is None and s.ttft_s is not None
        ],
        "tpot_s": [s.tpot_s for s in completed if s.tpot_s is not None],
        "e2e_s": [s.e2e_s for s in completed if s.e2e_s is not None],
    }
    pcts = {
        name: {pct_key(q): percentile(vals, q) for q in qs}
        for name, vals in populations.items()
    }
    send_lags = [s.sent_s - s.scheduled_s for s in result.samples]
    n = len(result.samples)
    return {
        "requests": n,
        "completed": len(completed),
        "disconnected": len(disconnected),
        "errors": errors,
        "num_errors": len(errored),
        "error_rate": len(errored) / max(n, 1),
        # Shed/failure split (see SHED_ERROR_MARKER): error_rate above
        # stays the union for back-compat with recorded trajectories.
        "num_shed": len(shed),
        "shed_rate": len(shed) / max(n, 1),
        "num_failures": len(failed),
        "failure_rate": len(failed) / max(n, 1),
        "shed_latency_s": {
            pct_key(q): percentile(shed_latencies, q) for q in qs
        },
        "offered_rate": result.offered_rate,
        "achieved_rate": result.achieved_rate,
        "offered_duration_s": result.offered_duration_s,
        "wall_duration_s": result.wall_duration_s,
        "tokens_received": sum(s.num_tokens for s in result.samples),
        "percentiles": pcts,
        "sample_counts": {k: len(v) for k, v in populations.items()},
        # Open-loop validity: the p99 send lag must stay tiny relative to
        # the latencies being measured, or the HARNESS (not the server)
        # was the bottleneck and the record is suspect.
        "send_lag_s": {
            "p50": percentile(send_lags, 50.0),
            "p99": percentile(send_lags, 99.0),
        },
    }


def engine_window(engine_id: str) -> dict:
    """Snapshot the engine's request histograms (one series per metric,
    keyed by the engine tag). Take one before and one after a run and
    diff them with `engine_percentiles` to percentile just that window."""
    tags = {"engine": engine_id}
    out = {}
    for metric, name in ENGINE_HISTOGRAMS.items():
        try:
            out[metric] = histogram_snapshot(name, tags)
        except KeyError:
            # Histogram not registered yet (engine has served nothing
            # since the last registry reset): an all-zero window.
            out[metric] = None
    return out


def engine_percentiles(
    before: dict, after: dict, qs: Sequence[float] = (50.0, 99.0)
) -> dict:
    """Percentiles of the before→after histogram delta, per metric."""
    out = {}
    for metric, post in after.items():
        if post is None:
            out[metric] = {pct_key(q): None for q in qs}
            continue
        pre = before.get(metric)
        pre_buckets = (
            pre["buckets"] if pre is not None else [0] * len(post["buckets"])
        )
        delta = [b - a for a, b in zip(pre_buckets, post["buckets"])]
        out[metric] = {
            pct_key(q): percentile_from_buckets(
                post["boundaries"], delta, q
            )
            for q in qs
        }
        out[metric]["count"] = sum(delta)
    return out


def cross_check(
    report: dict,
    engine_pcts: dict,
    engine_after: dict,
    qs: Sequence[float] = (50.0, 99.0),
    metrics: Sequence[str] = ("ttft_s", "tpot_s"),
    hop_allowance_s: float = 0.005,
) -> dict:
    """Compare loadgen-side and engine-side percentiles bucket-wise.

    The two estimates are binned into the engine histogram's own decade
    ladder; an entry agrees when its bucket indices differ by at most
    one, OR the absolute difference is within `hop_allowance_s` — the
    client→replica→engine-actor hop is a small constant the engine can't
    see, and at sub-5ms CPU tiny-model latencies that constant alone can
    straddle two ladder buckets (at production-scale latencies the
    bucket criterion dominates and the allowance is inert). A bigger
    disagreement means a broken clock or sample population and
    invalidates the record."""
    out = {"agreed": True}
    for metric in metrics:
        snap = engine_after.get(metric)
        if snap is None:
            out[metric] = {"skipped": "engine histogram missing"}
            continue
        boundaries = snap["boundaries"]
        per_q = {}
        for q in qs:
            key = pct_key(q)
            lg = report["percentiles"].get(metric, {}).get(key)
            eng = engine_pcts.get(metric, {}).get(key)
            if lg is None or eng is None:
                per_q[key] = {
                    "loadgen_s": lg,
                    "engine_s": eng,
                    "agree": None,
                }
                continue
            bi_lg = bucket_index(boundaries, lg)
            bi_eng = bucket_index(boundaries, eng)
            within = abs(bi_lg - bi_eng) <= 1
            ok = within or abs(lg - eng) <= hop_allowance_s
            per_q[key] = {
                "loadgen_s": lg,
                "engine_s": eng,
                "loadgen_bucket": bi_lg,
                "engine_bucket": bi_eng,
                "within_one_bucket": within,
                "agree": ok,
            }
            if not ok:
                out["agreed"] = False
        out[metric] = per_q
    return out


def format_report(report: dict, verdicts: Sequence[dict] = ()) -> str:
    """Human-readable one-cell summary (the CLI's `loadgen report`)."""
    lines = [
        f"requests={report['requests']} completed={report['completed']} "
        f"disconnected={report['disconnected']} "
        f"errors={report['num_errors']} ({report['errors']})"
        + (
            f" shed={report['num_shed']} failed={report['num_failures']}"
            if report.get("num_shed")
            else ""
        ),
        f"offered={report['offered_rate']:.2f}/s "
        f"achieved={report['achieved_rate']:.2f}/s "
        f"wall={report['wall_duration_s']:.2f}s",
    ]
    for metric in ("ttft_s", "tpot_s", "e2e_s"):
        pcts = report["percentiles"].get(metric, {})
        parts = [
            f"{k}={v * 1e3:.1f}ms"
            for k, v in pcts.items()
            if v is not None
        ]
        lines.append(f"{metric}: " + (" ".join(parts) or "no samples"))
    for verdict in verdicts:
        status = "PASS" if verdict["passed"] else "FAIL"
        failed = [
            c["rule"] for c in verdict["checks"] if not c["passed"]
        ]
        lines.append(
            f"SLO {verdict['slo']}: {status}"
            + (f" (failed: {', '.join(failed)})" if failed else "")
        )
    return "\n".join(lines)
