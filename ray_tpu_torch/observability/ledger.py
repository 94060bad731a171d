"""Fleet time ledger — decompose engine step wall time into components.

Every flight-recorder step record (llm/engine.py) carries the raw
timeline of one engine step: wall-clock stamps (`time` at step start,
`dispatch_time`, `ready_time`, per-commit `time`) plus measured
sub-durations (`prefill_s`, `fabric_wait_s`, per-commit `commit_s`,
`duration_s` for the whole step). `step_ledger` partitions `duration_s`
into named columns that sum to it *by construction* — each component is
allocated sequentially and clamped to the remaining budget, with the
unattributed remainder landing in `other_s` — so a replica's ledger
always sums to ~100% of its measured wall and a shortfall shows up as a
named column instead of silently vanishing.

Columns (the partition):

- ``idle_s``          — steps that did no work (no dispatch, no prefill,
                        no commits): the engine loop polled and found
                        nothing runnable.
- ``prefill_s``       — host time planning + dispatching chunked-prefill
                        programs (measured in `_run_prefill_chunks`).
- ``fabric_wait_s``   — blocking on KV-fabric restores: the store RPC
                        and the blocks' host-to-device copies, measured
                        in `LLMEngine._apply_fabric_restores` between
                        admission and chunk planning. It reads 0 with
                        the fabric off.
- ``host_schedule_s`` — host time between step start and decode dispatch
                        not already attributed to prefill/fabric:
                        scheduler admission, batch assembly, input prep.
- ``device_s``        — dispatch → tokens ready on host. On the sync
                        loop this spans the card's compute + the blocking
                        copy of the tokens to the host; on the async double-buffered loop the
                        dispatch returns immediately and device time
                        hides behind the *next* step (shows up ~0 here,
                        with the wait folded into the commit stage that
                        blocks on the previous step's tokens).
- ``commit_s``        — token emission: detokenize-and-deliver after
                        tokens are on host (measured per commit entry).
- ``other_s``         — duration_s minus everything above (never
                        negative): unattributed host time.

Overlay (NOT part of the partition — do not add it to the sum):

- ``host_gap_s``      — the device-idle gap the engine measures between
                        consecutive dispatches. It straddles the
                        previous step's commit tail and this step's
                        pre-dispatch window, so it overlaps the
                        partition columns; it is reported alongside them
                        as the "device starvation" signal.

`replica_ledger` sums step ledgers over a flight-record ring and adds a
``loop_s`` column for the wall-clock span not covered by any step record
(LLMServer._loop overhead, sleeps between steps): span from the first
step's start to the last step's end, minus the sum of step durations.
With that column, ledger columns sum to ~100% of the replica's measured
wall span — the acceptance check the fleet tests and `chip_smoke.py`
assert (coverage within 1 ± 0.05).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

# Partition columns, in allocation order. `replica_ledger` adds
# "loop_s" (inter-step wall not inside any step record) at the end.
LEDGER_COLUMNS = (
    "idle_s",
    "prefill_s",
    "fabric_wait_s",
    "host_schedule_s",
    "device_s",
    "commit_s",
    "other_s",
)

REPLICA_COLUMNS = LEDGER_COLUMNS + ("loop_s",)


def _clamp(value: Optional[float], budget: float) -> float:
    """A component can never exceed the unallocated remainder of the
    step's duration — measured sub-durations overlap at the edges
    (perf_counter rounding, wall-vs-perf skew), and clamping is what
    makes the partition sum exactly."""
    if value is None or value <= 0.0 or budget <= 0.0:
        return 0.0
    return min(float(value), budget)


def step_ledger(record: dict) -> dict:
    """Partition one flight-record step's `duration_s` into
    LEDGER_COLUMNS (sums to duration_s by construction), plus the
    `host_gap_s` overlay."""
    duration = float(record.get("duration_s") or 0.0)
    out = {col: 0.0 for col in LEDGER_COLUMNS}
    out["duration_s"] = duration
    out["host_gap_s"] = float(record.get("host_gap_s") or 0.0)
    budget = duration

    t_start = record.get("time")
    t_dispatch = record.get("dispatch_time")
    t_ready = record.get("ready_time")
    commits = record.get("commits") or ()
    prefill_s = record.get("prefill_s") or 0.0
    fabric_s = record.get("fabric_wait_s") or 0.0

    did_work = bool(
        t_dispatch is not None or commits or prefill_s > 0 or fabric_s > 0
    )
    if not did_work:
        out["idle_s"] = budget
        return out

    out["prefill_s"] = _clamp(prefill_s, budget)
    budget -= out["prefill_s"]
    out["fabric_wait_s"] = _clamp(fabric_s, budget)
    budget -= out["fabric_wait_s"]

    if t_dispatch is not None and t_start is not None:
        # Pre-dispatch host time not already attributed to prefill or
        # fabric: scheduler admission + batch assembly + input prep.
        sched = (
            float(t_dispatch)
            - float(t_start)
            - out["prefill_s"]
            - out["fabric_wait_s"]
        )
        out["host_schedule_s"] = _clamp(sched, budget)
        budget -= out["host_schedule_s"]

    if t_dispatch is not None and t_ready is not None:
        out["device_s"] = _clamp(float(t_ready) - float(t_dispatch), budget)
        budget -= out["device_s"]

    commit = 0.0
    for entry in commits:
        c = entry.get("commit_s") if isinstance(entry, dict) else None
        if c:
            commit += float(c)
    out["commit_s"] = _clamp(commit, budget)
    budget -= out["commit_s"]

    out["other_s"] = max(budget, 0.0)
    return out


def _committed_tokens(steps: Sequence[dict]) -> int:
    total = 0
    for record in steps:
        for entry in record.get("commits") or ():
            if isinstance(entry, dict):
                total += int(entry.get("tokens") or 0)
    return total


def replica_ledger(
    steps: Sequence[dict],
    *,
    model_params: Optional[int] = None,
    peak_flops_per_s: Optional[float] = None,
) -> dict:
    """Aggregate step ledgers over one replica's flight-record ring.

    Returns column sums (REPLICA_COLUMNS, incl. the inter-step
    ``loop_s``), per-column fractions of the measured wall span,
    goodput (committed tokens / span), and an MFU estimate when both
    `model_params` and a peak-FLOPs figure are known.
    """
    columns = {col: 0.0 for col in REPLICA_COLUMNS}
    steps = [s for s in steps if s.get("duration_s") is not None]
    if not steps:
        return {
            "steps": 0,
            "wall_s": 0.0,
            "columns": columns,
            "fractions": {},
            "ledger_sum_s": 0.0,
            "coverage": None,
            "host_gap_s": 0.0,
            "committed_tokens": 0,
            "goodput_tokens_per_s": 0.0,
            "mfu": None,
        }

    host_gap = 0.0
    duration_total = 0.0
    for record in steps:
        step = step_ledger(record)
        for col in LEDGER_COLUMNS:
            columns[col] += step[col]
        host_gap += step["host_gap_s"]
        duration_total += step["duration_s"]

    # Replica wall = wall-clock span from the first recorded step's start
    # to the last one's end. duration_s is perf_counter-measured, so the
    # coverage ratio below is a real cross-clock check, not a tautology.
    first = steps[0]
    last = steps[-1]
    span = None
    if first.get("time") is not None and last.get("time") is not None:
        span = (float(last["time"]) + float(last.get("duration_s") or 0.0)) - (
            float(first["time"])
        )
    if span is None or span <= 0.0:
        span = duration_total
    columns["loop_s"] = max(span - duration_total, 0.0)

    ledger_sum = sum(columns[col] for col in REPLICA_COLUMNS)
    wall = max(span, 1e-9)
    fractions = {col: columns[col] / wall for col in REPLICA_COLUMNS}
    tokens = _committed_tokens(steps)
    goodput = tokens / wall
    if peak_flops_per_s is None:
        peak_flops_per_s = default_peak_flops_per_s()
    return {
        "steps": len(steps),
        "wall_s": span,
        "columns": columns,
        "fractions": fractions,
        "ledger_sum_s": ledger_sum,
        # ledger_sum / wall — the ~100% acceptance number.
        "coverage": ledger_sum / wall,
        "host_gap_s": host_gap,
        "committed_tokens": tokens,
        "goodput_tokens_per_s": goodput,
        "mfu": mfu_estimate(model_params, goodput, peak_flops_per_s),
    }


def mfu_estimate(
    model_params: Optional[int],
    tokens_per_s: float,
    peak_flops_per_s: Optional[float],
) -> Optional[float]:
    """Decode-side model-FLOPs-utilization: ~2 FLOPs per parameter per
    generated token (forward pass), over device peak. None when either
    the parameter count or the peak figure is unknown (e.g. CPU runs
    have no meaningful peak)."""
    if not model_params or not peak_flops_per_s or peak_flops_per_s <= 0:
        return None
    return (2.0 * float(model_params) * float(tokens_per_s)) / float(
        peak_flops_per_s
    )


def default_peak_flops_per_s() -> Optional[float]:
    """Per-device peak FLOP/s for MFU accounting. No portable API exposes
    this, so it comes from the RAY_TPU_PEAK_FLOPS env var (set it to the
    card's dense bf16 spec number, e.g. 989e12 for an H100 SXM, the
    `PEAK_FLOPS` of `ray_tpu_torch.profiling.timing`); None means MFU is
    reported as unknown rather than guessed."""
    raw = os.environ.get("RAY_TPU_PEAK_FLOPS")
    if not raw:
        return None
    try:
        value = float(raw)
    except ValueError:
        return None
    return value if value > 0 else None


def fleet_ledger(replicas: dict) -> dict:
    """Merge per-replica ledgers ({replica_name: replica_ledger()}) into
    one fleet view: column sums, busiest-column ranking, total goodput
    (sum of per-replica goodputs — replicas run concurrently, so
    tokens/s adds), and the worst per-replica coverage (the number the
    obs-smoke gate checks)."""
    columns = {col: 0.0 for col in REPLICA_COLUMNS}
    tokens = 0
    goodput = 0.0
    wall = 0.0
    coverages = []
    mfus = []
    for ledger in replicas.values():
        for col in REPLICA_COLUMNS:
            columns[col] += ledger["columns"].get(col, 0.0)
        tokens += ledger["committed_tokens"]
        goodput += ledger["goodput_tokens_per_s"]
        wall = max(wall, ledger["wall_s"])
        if ledger.get("coverage") is not None:
            coverages.append(ledger["coverage"])
        if ledger.get("mfu") is not None:
            mfus.append(ledger["mfu"])
    total = sum(columns.values())
    fractions = (
        {col: columns[col] / total for col in REPLICA_COLUMNS}
        if total > 0
        else {}
    )
    ranked = sorted(
        ((col, columns[col]) for col in REPLICA_COLUMNS),
        key=lambda kv: kv[1],
        reverse=True,
    )
    return {
        "replicas": len(replicas),
        "columns": columns,
        "fractions": fractions,
        "bottlenecks": [col for col, v in ranked if v > 0],
        "committed_tokens": tokens,
        "goodput_tokens_per_s": goodput,
        "wall_s": wall,
        "min_coverage": min(coverages) if coverages else None,
        "max_coverage": max(coverages) if coverages else None,
        "mfu": max(mfus) if mfus else None,
    }
