"""Training-path observability: per-worker step profiler + run telemetry.

The training mirror of ``llm/observability.py`` (the serving plane),
gated by ``TrainConfig.instrument`` the way the engine plane is gated by
``EngineConfig.instrument``:

  * ``StepProfiler`` — one per ``RayTrainWorker`` runner thread. A report
    *round* runs from just before one ``session.report`` rendezvous put to
    just before the next; within it, wall time is attributed to phases:

      - ``report``     time blocked in the rendezvous (driver consumption);
                       always at the start of the round it is recorded in
      - ``data_wait``  ``prepare_batch`` (the host→device copy)
      - ``compute``    ``prepare_step``-wrapped steps (bounded by
                       ``torch.cuda.synchronize``, so asynchronous launches
                       cannot hide device time)
      - ``collective`` host collectives (``util.collective`` allreduce/
                       broadcast/barrier/...)
      - ``checkpoint`` ``Checkpoint.from_dict``

    Rounds land in a bounded per-worker ring (``RayTrainWorker.
    profile_records`` → ``WorkerGroup.profile_records``) AND ride each
    report to the driver, so the trainer aggregates without extra RPCs.
    Every phase clock doubles as a fault-injection site
    (``train.<phase>``, detail ``rank=<r>``) so chaos tests can delay one
    rank's phase deterministically.

  * ``TrainRunRecord`` — driver-side, one per ``fit()``. Per round it
    computes per-phase min/median/max across ranks, flags *stragglers*
    (rank whose non-report work time exceeds the low-median across ranks
    by ``TrainConfig.straggler_factor``, with its dominant phase), observes
    the ``train_*`` histograms, and emits the connected trace:
    ``train.fit`` root → ``train.round`` per rendezvous → per-rank
    ``train.worker.round`` with per-phase children, stitched across actor
    boundaries by deterministic round span ids (``round_span_id``) via the
    ``tracing.emit_span`` explicit-context API.

Finished runs stay in a bounded process-local registry (``list_runs``).
"""

from __future__ import annotations

import contextlib
import statistics
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.fault_injection import maybe_fail
from ray_tpu_torch.util import tracing

TRAIN_PHASES = ("data_wait", "compute", "collective", "checkpoint", "report")

# One report round: from sub-ms (tight CPU loops in tests) to minutes
# (real epochs with checkpointing) — the serving decade ladder extended up.
ROUND_SECONDS_BOUNDARIES = [
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 300.0,
]
SAMPLES_PER_SECOND_BOUNDARIES = [
    1.0, 10.0, 100.0, 1e3, 1e4, 1e5, 1e6, 1e7,
]


def _train_metrics():
    """The train metric family, fetched lazily at write time so a
    ``reset_registry()`` between tests re-registers fresh instances on the
    next round (same contract as the engine metrics)."""
    from ray_tpu_torch.util.metrics import Counter, Histogram, get_or_create

    h_round = get_or_create(
        Histogram,
        "train_round_seconds",
        "Per-rank wall time attributed to one phase of one report round",
        boundaries=ROUND_SECONDS_BOUNDARIES,
        tag_keys=("phase",),
    )
    h_report = get_or_create(
        Histogram,
        "train_report_round_seconds",
        "Driver-observed wall time of one whole report round (rendezvous "
        "across all ranks + checkpoint registration)",
        boundaries=ROUND_SECONDS_BOUNDARIES,
    )
    h_sps = get_or_create(
        Histogram,
        "train_samples_per_second",
        "Training throughput per round, summed across ranks",
        boundaries=SAMPLES_PER_SECOND_BOUNDARIES,
    )
    c_straggler = get_or_create(
        Counter,
        "train_straggler_rounds",
        "Rank-rounds flagged as stragglers, by dominant phase",
        tag_keys=("phase",),
    )
    return h_round, h_report, h_sps, c_straggler


def round_span_id(fit_span_id: str, round_idx: int) -> str:
    """Deterministic span id for round N of a fit: the driver (emitting
    ``train.round``) and every worker (parenting ``train.worker.round``)
    derive the same id with no coordination, which is what connects the
    trace across the actor boundary."""
    return f"{fit_span_id[:10]}{round_idx & 0xFFFFFF:06x}"


def current_profiler() -> Optional["StepProfiler"]:
    """The active worker's profiler, or None outside an instrumented
    training session (driver code, tune trial runners, plain tasks) —
    every hook in the hot path is one attribute read + None check."""
    from ray_tpu_torch.air.session import _get_session

    session = _get_session()
    if session is None:
        return None
    return getattr(session, "profiler", None)


def phase_or_null(name: str):
    """``profiler.phase(name)`` when inside an instrumented training
    session, else a no-op context — the shared guard for every profiler
    hook site (collectives, checkpoint constructors),
    so the hooked body is written exactly once."""
    profiler = current_profiler()
    if profiler is None:
        return contextlib.nullcontext()
    return profiler.phase(name)


def batch_rows(batch: Any) -> int:
    """Best-effort sample count of one batch (leading dimension)."""
    try:
        if isinstance(batch, dict):
            if not batch:
                return 0
            return len(next(iter(batch.values())))
        return len(batch)
    except Exception:
        return 0


class StepProfiler:
    """Per-worker phase clock + bounded round recorder.

    Single-writer (the train runner thread); ``records`` is a deque so the
    actor's ``profile_records`` snapshot from another thread is safe.
    """

    def __init__(
        self,
        rank: int,
        world_size: int,
        trace: Optional[tuple] = None,
        round_offset: int = 0,
        capacity: int = 512,
    ):
        self.rank = rank
        self.world_size = world_size
        self.trace = tuple(trace) if trace else None  # (trace_id, fit_span_id)
        self.records: deque = deque(maxlen=capacity)
        self._detail = f"rank={rank}"
        self._round = round_offset
        self._round_start = time.perf_counter()
        self._phases: Dict[str, float] = {p: 0.0 for p in TRAIN_PHASES}
        self._samples = 0

    @contextlib.contextmanager
    def phase(self, name: str):
        """Attribute the body's wall time to `name`. The fault-injection
        site fires inside the clock, so an injected delay lands in the
        phase it targets (the straggler-test hook)."""
        t0 = time.perf_counter()
        try:
            maybe_fail(f"train.{name}", self._detail)
            yield
        finally:
            self._phases[name] += time.perf_counter() - t0

    def add(self, name: str, seconds: float) -> None:
        self._phases[name] += seconds

    def add_samples(self, n: int) -> None:
        self._samples += n

    def end_round(self) -> dict:
        """Close the current round (called by ``session.report`` just
        before the rendezvous put), record it, emit its worker spans, and
        return the record so it can ride the report to the driver."""
        now_p = time.perf_counter()
        now_ts = time.time()
        duration = now_p - self._round_start
        phases = {p: round(v, 6) for p, v in self._phases.items()}
        record = {
            "round": self._round,
            "rank": self.rank,
            "duration_s": round(duration, 6),
            "phases": phases,
            "samples": self._samples,
            "time": now_ts,
        }
        self.records.append(record)
        if self.trace is not None:
            self._emit_round_spans(record, now_ts - duration, now_ts)
        self._round += 1
        self._round_start = now_p
        self._phases = {p: 0.0 for p in TRAIN_PHASES}
        self._samples = 0
        return record

    def _emit_round_spans(self, record: dict, start_ts: float, end_ts: float) -> None:
        trace_id, fit_span_id = self.trace
        worker_span_id = tracing.new_span_id()
        tracing.emit_span(
            "train.worker.round",
            start_ts,
            end_ts,
            trace_id=trace_id,
            parent_span_id=round_span_id(fit_span_id, record["round"]),
            span_id=worker_span_id,
            attributes={
                "rank": self.rank,
                "round": record["round"],
                "samples": record["samples"],
                **{f"{p}_s": v for p, v in record["phases"].items()},
            },
        )
        # Per-phase children, laid out sequentially in execution order
        # (report blocks at the round's start). Phase time is accumulated,
        # not contiguous, so the layout is synthetic — durations are exact.
        cursor = start_ts
        for phase in ("report", "data_wait", "compute", "collective", "checkpoint"):
            seconds = record["phases"][phase]
            if seconds <= 1e-6:
                continue
            tracing.emit_span(
                f"train.worker.{phase}",
                cursor,
                cursor + seconds,
                trace_id=trace_id,
                parent_span_id=worker_span_id,
            )
            cursor += seconds


# ---------------------------------------------------------------------------
# Driver side: per-fit aggregation, straggler detection, run registry
# ---------------------------------------------------------------------------


class TrainRunRecord:
    """One ``fit()``'s telemetry: bounded round records, cumulative phase
    stats, straggler events. Written by the driver's fit loop; snapshotted
    from other threads (bounded deques, no locks on
    the write path)."""

    def __init__(
        self,
        name: str,
        trainer: str,
        num_workers: int,
        straggler_factor: float = 2.0,
        straggler_min_s: float = 0.05,
        rounds_capacity: int = 256,
    ):
        self.run_id = uuid.uuid4().hex[:12]
        self.name = name
        self.trainer = trainer
        self.num_workers = num_workers
        self.straggler_factor = straggler_factor
        self.straggler_min_s = straggler_min_s
        self.trace_id = tracing.new_span_id()
        self.fit_span_id = tracing.new_span_id()
        self.started = time.time()
        self.finished: Optional[float] = None
        self.error: Optional[str] = None
        self.rounds: deque = deque(maxlen=rounds_capacity)
        self.rounds_total = 0
        self.straggler_rounds = 0
        self.stragglers: deque = deque(maxlen=64)
        self.samples_total = 0
        self._phase_values: Dict[str, deque] = {
            p: deque(maxlen=2048) for p in TRAIN_PHASES
        }
        # Fetched once per run, not per round: get_or_create takes the
        # registry lock, and instances survive reset_registry() anyway
        # (they re-register lazily on their next write). Pre-merged tag
        # dicts keep the per-round loop allocation-free.
        self._metrics = _train_metrics()
        self._phase_tags = {p: {"phase": p} for p in TRAIN_PHASES}

    # -- per-round ----------------------------------------------------------

    def record_round(
        self,
        round_idx: int,
        profiles: List[Optional[dict]],
        start_ts: float,
        end_ts: float,
        checkpoint_s: float = 0.0,
    ) -> dict:
        """Fold one rendezvous round's per-rank records in: histograms,
        min/median/max per phase across ranks, straggler flags, and the
        ``train.round`` span the workers' round spans hang under."""
        h_round, h_report, h_sps, c_straggler = self._metrics
        profiles = [p for p in profiles if p]
        round_wall = max(end_ts - start_ts, 1e-9)
        for record in profiles:
            for phase in TRAIN_PHASES:
                value = record["phases"].get(phase, 0.0)
                h_round.observe(value, self._phase_tags[phase])
                self._phase_values[phase].append(value)
        h_report.observe(round_wall)
        samples = sum(r.get("samples", 0) for r in profiles)
        self.samples_total += samples
        if samples:
            h_sps.observe(samples / round_wall)

        stragglers = self._detect_stragglers(round_idx, profiles)
        for s in stragglers:
            c_straggler.inc(1.0, {"phase": s["phase"]})

        row = {
            "round": round_idx,
            "duration_s": round(round_wall, 6),
            "checkpoint_s": round(checkpoint_s, 6),
            "samples": samples,
            "phase_stats": _phase_stats(profiles),
            "stragglers": stragglers,
            "ranks": profiles,
            "time": end_ts,
        }
        self.rounds.append(row)
        self.rounds_total += 1
        if stragglers:
            self.straggler_rounds += 1

        tracing.emit_span(
            "train.round",
            start_ts,
            end_ts,
            trace_id=self.trace_id,
            parent_span_id=self.fit_span_id,
            span_id=round_span_id(self.fit_span_id, round_idx),
            attributes={
                "round": round_idx,
                "ranks": len(profiles),
                "samples": samples,
                "checkpoint_s": round(checkpoint_s, 6),
                "stragglers": [s["rank"] for s in stragglers],
            },
        )
        return row

    def _detect_stragglers(
        self, round_idx: int, profiles: List[dict]
    ) -> List[dict]:
        """A straggler's *work* time (round minus rendezvous wait) exceeds
        the low-median across ranks by ``straggler_factor``. Total round
        times are useless here: the rendezvous equalizes them — fast ranks
        just block longer in ``report`` — so the report phase is excluded
        from both the comparison and the dominant-phase blame."""
        if len(profiles) < 2:
            return []
        works = {
            r["rank"]: max(r["duration_s"] - r["phases"].get("report", 0.0), 0.0)
            for r in profiles
        }
        # median_low: with few ranks (the common 2-4 worker case) the
        # interpolated median is dragged halfway toward the straggler
        # itself, which can mask it exactly at the threshold.
        median = statistics.median_low(list(works.values()))
        out = []
        for record in profiles:
            work = works[record["rank"]]
            if work <= self.straggler_factor * median:
                continue
            if work - median < self.straggler_min_s:
                continue
            phases = {
                p: v for p, v in record["phases"].items() if p != "report"
            }
            # Blame the largest phase clock — unless the clocks don't cover
            # the excess work (unhooked user code), in which case naming a
            # near-zero phase would send the operator chasing the wrong
            # subsystem: call it what it is.
            tracked = sum(phases.values())
            if phases and tracked >= 0.5 * work:
                dominant = max(phases, key=phases.get)
            else:
                dominant = "untracked"
            out.append(
                {
                    "round": round_idx,
                    "rank": record["rank"],
                    "work_s": round(work, 6),
                    "median_work_s": round(median, 6),
                    "phase": dominant,
                }
            )
        self.stragglers.extend(out)
        return out

    # -- lifecycle ----------------------------------------------------------

    def finish(self, error: Optional[BaseException] = None) -> None:
        self.finished = time.time()
        self.error = repr(error) if error is not None else None
        tracing.emit_span(
            "train.fit",
            self.started,
            self.finished,
            trace_id=self.trace_id,
            parent_span_id=None,
            span_id=self.fit_span_id,
            attributes={
                "run_id": self.run_id,
                "name": self.name,
                "trainer": self.trainer,
                "num_workers": self.num_workers,
                "rounds": self.rounds_total,
                "straggler_rounds": self.straggler_rounds,
                "status": "error" if error is not None else "ok",
                **({"error": self.error} if error is not None else {}),
            },
        )

    def report(self, rounds_limit: int = 32) -> dict:
        """Aggregate snapshot: what ``Result.train_report`` carries."""
        rounds = list(self.rounds)
        if rounds_limit >= 0:
            rounds = rounds[len(rounds) - rounds_limit:] if rounds_limit else []
        return {
            "run_id": self.run_id,
            "name": self.name,
            "trainer": self.trainer,
            "num_workers": self.num_workers,
            "trace_id": self.trace_id,
            "started": self.started,
            "finished": self.finished,
            "error": self.error,
            "rounds_total": self.rounds_total,
            "samples_total": self.samples_total,
            "straggler_rounds": self.straggler_rounds,
            "stragglers": list(self.stragglers),
            "phase_stats": {
                p: _min_median_max(list(vs))
                for p, vs in self._phase_values.items()
                if vs
            },
            "rounds": rounds,
        }


def _min_median_max(values: List[float]) -> dict:
    """One sort, three reads (statistics.median re-sorts and type-checks;
    this runs 5x per round on the driver's hot path)."""
    ordered = sorted(values)
    n = len(ordered)
    mid = ordered[n // 2] if n % 2 else (ordered[n // 2 - 1] + ordered[n // 2]) / 2
    return {
        "min": round(ordered[0], 6),
        "median": round(mid, 6),
        "max": round(ordered[-1], 6),
    }


def _phase_stats(profiles: List[dict]) -> Dict[str, dict]:
    out = {}
    for phase in TRAIN_PHASES:
        values = [r["phases"].get(phase, 0.0) for r in profiles]
        if values:
            out[phase] = _min_median_max(values)
    return out


_RUNS_LOCK = threading.Lock()
_RUNS: "OrderedDict[str, TrainRunRecord]" = OrderedDict()
_RUNS_CAPACITY = 32


def register_run(record: TrainRunRecord) -> TrainRunRecord:
    with _RUNS_LOCK:
        _RUNS[record.run_id] = record
        while len(_RUNS) > _RUNS_CAPACITY:
            _RUNS.popitem(last=False)
    return record


def get_run(run_id: str) -> Optional[TrainRunRecord]:
    with _RUNS_LOCK:
        return _RUNS.get(run_id)


def list_runs(limit: int = 16, rounds_limit: int = 8) -> List[dict]:
    """Newest-first snapshots of recent training runs (in this process —
    the driver and the in-process head share it)."""
    with _RUNS_LOCK:
        records = list(_RUNS.values())
    return [r.report(rounds_limit=rounds_limit) for r in records[::-1][:limit]]


def reset_runs() -> None:
    """Test isolation."""
    with _RUNS_LOCK:
        _RUNS.clear()
