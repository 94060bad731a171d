"""Per-request serving observability: lifecycle spans + flight recorder.

Two pieces the engine hooks into (gated by EngineConfig.instrument):

  * RequestTrace — one per in-flight request. The trace context is captured
    once at submission (the LLMServer.generate actor-task span, which chains
    back through the replica task to the Serve handle caller), and every
    lifecycle phase — queue wait, prefill (full/partial/CoW), decode
    stretches, preemption + resume, terminal state — is emitted as a span
    against it from the engine loop thread via tracing.emit_span, so a
    streamed request yields one connected trace in tracing.traces().
    Decode is recorded per STRETCH (admission → preempt/finish), never per
    token: the hot loop only bumps plain floats at step boundaries.

  * FlightRecorder — a bounded ring of structured per-step records (step
    index, phase, batch size, tokens in/out, buckets, prefix-cache hits,
    preemptions, duration; with speculative decoding on, verify steps add
    a "speculation" record — proposer mode, fed bucket, proposed /
    accepted / emitted counts) plus warmup compile events (cold-compile
    blame) and step failures from the PR 3 poison-isolation path. Exposed
    through LLMServer.flight_record() and the dashboard /api/llm panel.

The request latency histograms live here too so every engine shares one
registered metric per name (vLLM reports the same trio — TTFT, time per
output token, e2e — as the primary serving SLO metrics).
"""

from __future__ import annotations

import time
import uuid
from collections import deque
from typing import List, Optional

from ray_tpu_torch.util import tracing

# Bucket rationale: requests cover ~1 ms (cache-hit prefill of a short
# prompt on warm programs) to minutes (long decode under preemption), so
# request-level histograms use a 1-2.5-5 decade ladder across ms → minute.
REQUEST_SECONDS_BOUNDARIES = [
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
]
# Per-output-token latency: decode steps are ~100 µs – 100 ms per token
# depending on batch width and hardware; the ladder starts a decade lower.
PER_TOKEN_SECONDS_BOUNDARIES = [
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0,
]
# One engine step (a single jitted program dispatch + host bookkeeping).
STEP_SECONDS_BOUNDARIES = [
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5,
]
# Host gap between consecutive decode dispatches: how long the device sat
# idle waiting on host scheduling/commit work before the next program was
# queued. This is the number async_scheduling exists to shrink — a chained
# dispatch issued before the previous step's results were even fetched
# records 0, so the ladder starts at 10 µs and the first bucket is the
# "pipelined" bucket.
HOST_GAP_SECONDS_BOUNDARIES = [
    0.00001, 0.000025, 0.00005, 0.0001, 0.00025, 0.0005, 0.001,
    0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
]


class RequestTrace:
    """Phase-span emitter for one request; all mutation happens at phase
    boundaries (admission, prefill end, preemption, finish) — zero work in
    the per-token decode path."""

    __slots__ = (
        "request_id",
        "trace_id",
        "parent_span_id",
        "root_span_id",
        "submit_s",
        "queue_start",
        "queue_waits",
        "first_token_s",
        "stretch_start",
        "stretch_base",
        "prefills",
        "preempts",
        "error",
    )

    def __init__(self, request_id: str, parent_ctx: Optional[tuple]):
        self.request_id = request_id
        if parent_ctx is not None:
            self.trace_id, self.parent_span_id = parent_ctx
        else:
            self.trace_id = uuid.uuid4().hex[:16]
            self.parent_span_id = None
        self.root_span_id = tracing.new_span_id()
        now = time.time()
        self.submit_s = now
        self.queue_start: Optional[float] = now  # in queue from submission
        self.queue_waits = 0
        self.first_token_s: Optional[float] = None
        self.stretch_start: Optional[float] = None
        self.stretch_base = 0  # generated-token count when the stretch began
        self.prefills = 0
        self.preempts = 0
        self.error: Optional[str] = None

    def _emit(self, name, start_s, end_s, attributes=None) -> None:
        tracing.emit_span(
            name,
            start_s,
            end_s,
            trace_id=self.trace_id,
            parent_span_id=self.root_span_id,
            attributes=attributes,
        )

    def on_admitted(self, now: float) -> float:
        """Close the current queue-wait span; returns the wait in seconds
        (initial admission and every preempt-resume each count one wait)."""
        start = self.queue_start if self.queue_start is not None else now
        self.queue_start = None
        self.queue_waits += 1
        self._emit(
            "llm.queue", start, now, {"wait": self.queue_waits - 1}
        )
        return now - start

    def on_prefilled(
        self, start_s: float, now: float, kind: str, bucket: int,
        n_tokens: int, cached_tokens: int, n_generated: int,
        chunk: int = 0, final: bool = True,
    ) -> None:
        """One prefill program ran for this request (kind: full | partial |
        cow; `chunk` indexes the dispatch within the current admission
        under chunked prefill). Only the FINAL chunk produces a token, so
        only it sets first-token time and opens a decode stretch: tokens
        generated from here to the next preempt/finish belong to it (the
        prefill's own first token is attributed to the prefill span, not
        the stretch). Continuation chunks just record their span — TTFT
        keeps exactly one observation per request either way."""
        self.prefills += 1
        self._emit(
            "llm.prefill",
            start_s,
            now,
            {
                "kind": kind,
                "bucket": bucket,
                "tokens": n_tokens,
                "cached_tokens": cached_tokens,
                "chunk": chunk,
                "final": final,
            },
        )
        if not final:
            return
        if self.first_token_s is None:
            self.first_token_s = now
        self.stretch_start = now
        self.stretch_base = n_generated

    def _close_stretch(self, now: float, n_generated: int) -> None:
        if self.stretch_start is None:
            return
        tokens = n_generated - self.stretch_base
        if tokens > 0:
            self._emit(
                "llm.decode", self.stretch_start, now, {"tokens": tokens}
            )
        self.stretch_start = None
        self.stretch_base = n_generated

    def on_preempt(self, now: float, n_generated: int) -> None:
        """Recompute-style preemption: close the decode stretch, mark the
        event, and re-enter the queue (the resume prefill reopens it)."""
        self._close_stretch(now, n_generated)
        self.preempts += 1
        self._emit("llm.preempt", now, now, {"preemption": self.preempts})
        self.queue_start = now

    def on_finish(self, now: float, seq) -> None:
        """Terminal state: close any open stretch and the request root span.
        Dead-lettered requests (finish_reason="error") close with error
        status and the step exception that killed them."""
        self._close_stretch(now, len(seq.generated))
        attrs = {
            "request_id": self.request_id,
            "prompt_tokens": len(seq.request.prompt_ids),
            "generated_tokens": len(seq.generated),
            "finish_reason": seq.finish_reason,
            "preemptions": self.preempts,
            "prefills": self.prefills,
            "status": "error" if self.error is not None else "ok",
        }
        if self.first_token_s is not None:
            attrs["ttft_s"] = self.first_token_s - self.submit_s
        if self.error is not None:
            attrs["error"] = self.error
        tracing.emit_span(
            "llm.request",
            self.submit_s,
            now,
            trace_id=self.trace_id,
            parent_span_id=self.parent_span_id,
            span_id=self.root_span_id,
            attributes=attrs,
        )


class FlightRecorder:
    """Bounded rings of what the engine loop actually did.

    Writers are the engine step path (serialized by LLMServer's lock or the
    caller's single thread); deque appends are atomic, so readers snapshot
    safely from any thread. Failures are recorded even with instrumentation
    off — a crashed step must always leave a trace."""

    def __init__(self, capacity: int = 256):
        self.steps: deque = deque(maxlen=capacity)
        self.compile_events: deque = deque(maxlen=128)
        self.failures: deque = deque(maxlen=128)
        # Overload plane: bounded-admission rejections and deadline
        # expiries. Recorded even with instrumentation off, like
        # failures — shed/expired traffic is precisely the traffic an
        # operator will be asked to explain after the fact.
        self.sheds: deque = deque(maxlen=128)
        self.expiries: deque = deque(maxlen=128)

    def record_step(self, record: dict) -> None:
        self.steps.append(record)

    def record_compile(
        self, program: str, bucket: int, seconds: float
    ) -> None:
        """Warmup compile blame: which program/bucket cost how many cold
        seconds before the engine reported ready."""
        self.compile_events.append(
            {
                "program": program,
                "bucket": bucket,
                "compile_s": round(seconds, 6),
                "time": time.time(),
            }
        )

    def record_failure(
        self,
        step: int,
        error: str,
        request_id: Optional[str] = None,
        action: str = "retry",
    ) -> None:
        """One failed engine step and what the loop did about it:
        "dead_letter" (poison isolation), "retry" (unattributable,
        below threshold), or "wedged" (threshold tripped)."""
        self.failures.append(
            {
                "step": step,
                "error": error,
                "request_id": request_id,
                "action": action,
                "time": time.time(),
            }
        )

    def record_shed(
        self,
        request_id: Optional[str],
        reason: str,
        queue_len: int,
        step: int,
    ) -> None:
        """One submission rejected by bounded admission (or dead on
        arrival): why, and how deep the backlog stood when it was shed."""
        self.sheds.append(
            {
                "request_id": request_id,
                "reason": reason,
                "queue_len": queue_len,
                "step": step,
                "time": time.time(),
            }
        )

    def record_expiry(
        self,
        request_id: str,
        phase: str,
        step: int,
        tokens_generated: int,
    ) -> None:
        """One admitted request dropped at its deadline: "queued" means it
        never cost a prefill program; "running" means it was aborted
        mid-stream with its blocks reclaimed this step."""
        self.expiries.append(
            {
                "request_id": request_id,
                "phase": phase,
                "step": step,
                "tokens_generated": tokens_generated,
                "time": time.time(),
            }
        )

    def snapshot(self, steps_limit: Optional[int] = None) -> dict:
        steps: List[dict] = list(self.steps)
        if steps_limit is not None and steps_limit >= 0:
            # NOT steps[-steps_limit:]: a 0 limit must mean zero records,
            # but [-0:] slices the whole list.
            steps = (
                steps[max(len(steps) - steps_limit, 0) :]
                if steps_limit
                else []
            )
        return {
            "steps": steps,
            "compile_events": list(self.compile_events),
            "failures": list(self.failures),
            "sheds": list(self.sheds),
            "expiries": list(self.expiries),
        }
