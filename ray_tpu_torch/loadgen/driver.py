"""Open-loop load driver: fire at schedule time, never wait for replies.

`run_open_loop` walks a precomputed schedule (arrivals.py) and fires each
request (scenarios.py) at its offset against a Serve deployment handle —
the REAL serving path: router → `LLMIngress` replica → shared engine
actor, the same hops production traffic takes (`serve.build_app` +
`serve.run`), never a direct engine call. The sender thread only sleeps
and spawns; each request is consumed on its own thread, so a slow (or
collapsing) server never backpressures the arrival process — that is the
open-loop contract that makes queueing collapse visible.

Per request it records client-side TTFT (dispatch → first streamed
token), TPOT (mean inter-token gap after the first), e2e, tokens
received, send lag (actual fire vs scheduled — nonzero lag means the
HARNESS fell behind, a validity signal for the run), and the error class
for failures. Engine-side queue time is cross-checked from the
`llm_request_queue_time_seconds` histogram by the report instead (an
open-loop client cannot observe per-request queue placement).

Scenario kinds map to driver behavior: ``poison`` requests get a
deterministic injected fault armed at the engine's per-request decode
site before the run (the dead-letter path must isolate exactly them);
``disconnect`` requests stop consuming after `disconnect_after` tokens
and cancel the stream — the client-disconnect path the proxy takes.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Sequence

from ray_tpu_torch._private import fault_injection as fi
from ray_tpu_torch.loadgen.scenarios import LoadRequest

# Engine injection site for poison requests: the per-sequence decode
# commit, matched on request_id — fires on the request's first decoded
# token, after prefill succeeded (the nastier half of the poison space).
POISON_SITE = "llm.decode.seq"


@dataclasses.dataclass
class RequestSample:
    """What the client observed for one request."""

    request_id: str
    kind: str
    scenario: str
    session_id: Optional[str]
    scheduled_s: float
    sent_s: float = 0.0  # actual fire offset (sent_s - scheduled_s = lag)
    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None
    e2e_s: Optional[float] = None
    num_tokens: int = 0
    error: Optional[str] = None  # exception class name, None on success
    # Dispatch → error surfaced. For overload sheds this is the REJECTION
    # latency — the graceful-degradation gate requires rejections to be
    # fast (cheaper than an accepted request's first token), and e2e_s is
    # deliberately unset on errors so it can't carry the number.
    error_latency_s: Optional[float] = None
    disconnected: bool = False
    # Populated only with record_tokens=True: the exact delivered token
    # ids, so chaos runs can assert migrated streams token-identical to an
    # undisturbed run.
    token_ids: Optional[List[int]] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ScheduledEvent:
    """A control-plane action fired mid-run at a schedule offset (chaos
    gating: scale events under live open-loop traffic). `fn` runs on its
    own timer thread; outcome lands in `fired_s`/`error` and rides the
    run result."""

    offset_s: float
    name: str
    fn: Callable[[], None]
    fired_s: Optional[float] = None
    error: Optional[str] = None
    # Set by run_open_loop when the settle window closed before the
    # event's offset: the timer thread then stands down instead of firing
    # a control-plane action against post-run (or the next run's) state.
    # The lock makes cancel-vs-fire atomic — an event is either fired
    # (fired_s set, never cancelled) or cancelled (never fires), so the
    # serialized record can't read both.
    cancelled: bool = False
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def to_dict(self) -> dict:
        return {
            "offset_s": self.offset_s,
            "name": self.name,
            "fired_s": self.fired_s,
            "error": self.error,
            "cancelled": self.cancelled,
        }


@dataclasses.dataclass
class LoadRunResult:
    """One open-loop run: the samples plus the run geometry."""

    samples: List[RequestSample]
    offered_duration_s: float  # last scheduled arrival
    wall_duration_s: float  # fire of first request → last sample settled
    offered_rate: float
    events: List[ScheduledEvent] = dataclasses.field(default_factory=list)

    @property
    def completed(self) -> List[RequestSample]:
        return [
            s
            for s in self.samples
            if s.error is None and not s.disconnected
        ]

    @property
    def achieved_rate(self) -> float:
        return len(self.completed) / max(self.wall_duration_s, 1e-9)

    def to_dict(self) -> dict:
        return {
            "samples": [s.to_dict() for s in self.samples],
            "offered_duration_s": self.offered_duration_s,
            "wall_duration_s": self.wall_duration_s,
            "offered_rate": self.offered_rate,
            "achieved_rate": self.achieved_rate,
            "events": [e.to_dict() for e in self.events],
        }


def _drive_one(
    handle,
    req: LoadRequest,
    sample: RequestSample,
    t0: float,
    timeout_s: float,
    stream_resume_fn: Optional[Callable] = None,
    record_tokens: bool = False,
) -> None:
    """Consume one streamed request on its own thread. Timestamps are
    perf_counter offsets from the run origin `t0` (monotonic durations —
    wall clock would corrupt the percentiles under NTP steps). With a
    `stream_resume_fn` (e.g. llm_stream_resume), a replica dying or
    draining mid-stream migrates the stream to a surviving replica
    instead of erroring the sample."""
    sample.sent_s = time.perf_counter() - t0
    sent = sample.sent_s  # latency base until dispatch completes below
    first = last = None
    n = 0
    if record_tokens:
        sample.token_ids = []
    try:
        opts = {"stream": True}
        if stream_resume_fn is not None:
            opts["stream_resume_fn"] = stream_resume_fn
        gen = handle.options(**opts).remote(
            {
                "prompt_ids": list(req.prompt_ids),
                "max_new_tokens": req.max_new_tokens,
                "stream": True,
                "request_id": req.request_id,
                "timeout_s": timeout_s,
            }
        )
        # Latency base: dispatch complete (router picked a replica, the
        # task is en route). The client's own dispatch bookkeeping is not
        # server latency; everything after this — replica task queue,
        # engine admission queue, prefill — is, and lands in TTFT.
        sent = time.perf_counter() - t0
        for item in gen:
            now = time.perf_counter() - t0
            if first is None:
                first = now
            last = now
            n += 1
            if record_tokens:
                sample.token_ids.append(
                    item.get("token_id") if isinstance(item, dict) else item
                )
            if (
                req.disconnect_after is not None
                and n >= req.disconnect_after
            ):
                # Mid-stream client disconnect: stop consuming and cancel
                # the replica-side stream (the proxy's disconnect path).
                # The ingress must propagate an abort so the engine frees
                # the request's KV (and draft-mirror) blocks immediately.
                gen.cancel()
                sample.disconnected = True
                break
    except BaseException as exc:  # noqa: BLE001 — error CLASS is the datum
        sample.error = type(exc).__name__
        sample.error_latency_s = time.perf_counter() - t0 - sent
    end = time.perf_counter() - t0
    sample.num_tokens = n
    if first is not None:
        sample.ttft_s = first - sent
        if n >= 2:
            sample.tpot_s = (last - first) / (n - 1)
    if sample.error is None and not sample.disconnected:
        sample.e2e_s = end - sent


def arm_poison_faults(requests: Sequence[LoadRequest]) -> List[fi.FaultSpec]:
    """One deterministic injected fault per poison request, matched on its
    request_id at the engine's per-sequence decode site. Returns the live
    specs; the caller removes them after the run (run_open_loop does)."""
    return [
        fi.inject(
            POISON_SITE,
            match=req.request_id,
            nth=1,
            message=f"loadgen poison {req.request_id}",
        )
        for req in requests
        if req.kind == "poison"
    ]


def _fire_event(ev: ScheduledEvent, t0: float) -> None:
    delay = t0 + ev.offset_s - time.perf_counter()
    if delay > 0:
        time.sleep(delay)
    with ev._lock:
        if ev.cancelled:
            return
        ev.fired_s = time.perf_counter() - t0
    try:
        ev.fn()
    except Exception as exc:  # noqa: BLE001 — the outcome is the datum
        ev.error = repr(exc)


def run_open_loop(
    handle,
    requests: Sequence[LoadRequest],
    arrival_offsets: Sequence[float],
    timeout_s: float = 60.0,
    settle_timeout_s: float = 120.0,
    events: Sequence[ScheduledEvent] = (),
    stream_resume_fn: Optional[Callable] = None,
    record_tokens: bool = False,
) -> LoadRunResult:
    """Fire `requests[i]` at `arrival_offsets[i]` seconds from run start
    against `handle` (a Serve deployment handle for an LLMIngress app)
    and collect per-request samples. The sender never blocks on a
    response; after the last arrival it waits up to `settle_timeout_s`
    for in-flight requests to settle (stragglers are recorded with
    error="ClientSettleTimeout" — the run result stays complete even
    when the server collapsed under the offered load).

    `events` are ScheduledEvents fired at their own offsets on timer
    threads — the chaos-gating hook (e.g. a mid-run scale-down whose
    drained streams must migrate with zero drops). `stream_resume_fn`
    and `record_tokens` thread through to each consumer (see
    _drive_one)."""
    if len(requests) != len(arrival_offsets):
        raise ValueError(
            f"{len(requests)} requests but {len(arrival_offsets)} arrivals"
        )
    order = sorted(range(len(requests)), key=lambda i: arrival_offsets[i])
    samples = [
        RequestSample(
            request_id=req.request_id,
            kind=req.kind,
            scenario=req.scenario,
            session_id=req.session_id,
            scheduled_s=float(arrival_offsets[i]),
        )
        for i, req in enumerate(requests)
    ]
    poisons = arm_poison_faults(requests)
    threads: List[threading.Thread] = []
    event_threads: List[threading.Thread] = []
    events = list(events)
    t0 = time.perf_counter()
    try:
        for ev in events:
            th = threading.Thread(
                target=_fire_event,
                args=(ev, t0),
                name=f"loadgen-event-{ev.name}",
                daemon=True,
            )
            th.start()
            event_threads.append(th)
        for i in order:
            delay = t0 + arrival_offsets[i] - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            th = threading.Thread(
                target=_drive_one,
                args=(handle, requests[i], samples[i], t0, timeout_s),
                kwargs={
                    "stream_resume_fn": stream_resume_fn,
                    "record_tokens": record_tokens,
                },
                name=f"loadgen-{requests[i].request_id}",
                daemon=True,
            )
            th.start()
            threads.append(th)
        deadline = time.monotonic() + settle_timeout_s
        for th in threads + event_threads:
            th.join(timeout=max(deadline - time.monotonic(), 0.0))
        for i, th in zip(order, threads):
            if th.is_alive() and samples[i].error is None:
                samples[i].error = "ClientSettleTimeout"
        for ev, th in zip(events, event_threads):
            if th.is_alive():
                # Settle window closed before the offset: stand the timer
                # down so it can't fire against post-run serve state (or
                # mutate this result after it's been serialized). Under
                # the event lock: if the timer already passed its check,
                # fired_s is set and the event stays un-cancelled.
                with ev._lock:
                    if ev.fired_s is None:
                        ev.cancelled = True
    finally:
        for spec in poisons:
            fi.remove(spec)
    wall = time.perf_counter() - t0
    offered_duration = max(arrival_offsets) if len(arrival_offsets) else 0.0
    return LoadRunResult(
        samples=samples,
        offered_duration_s=offered_duration,
        wall_duration_s=wall,
        offered_rate=len(requests) / max(offered_duration, 1e-9),
        events=events,
    )
