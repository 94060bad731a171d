"""DeploymentHandle + client-side Router.

Reference: serve/handle.py:74 (RayServeHandle), serve/_private/router.py:338,
370 (Router.assign_replica: pick a replica with < max_concurrent_queries in
flight, block otherwise) and the LongPollClient (_private/long_poll.py:68)
keeping the replica set fresh without polling per-request.

Fault tolerance: a request that lands on a dead/unavailable replica is
re-dispatched to another one with exponential backoff, a per-request retry
budget, and an excluded-replica set (the reference router's
replica-unavailable retry path). Streaming responses can resume on the new
replica via a caller-supplied `resume_fn` that folds the items already
delivered into the re-submitted request — for LLM token streams
(ray_tpu_torch.llm.serve.llm_stream_resume) the resumed prefill is mostly prefix
cache hits and the client-visible stream stays contiguous. Budget
exhaustion raises the typed ReplicaUnavailableRetryExhausted instead of a
raw ActorDiedError.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
import uuid
from typing import Any, Callable, Optional

from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch._private.runtime import get_runtime
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    ActorUnavailableError,
    EngineOverloadedError,
    FleetOverloadedError,
    ReplicaDrainingError,
    ReplicaUnavailableRetryExhausted,
)

from ray_tpu_torch.serve.config import (
    DEFAULT_BACKOFF_INITIAL_S,
    DEFAULT_RETRY_BUDGET,
)
from ray_tpu_torch.util.consistent_hash import rendezvous_pick as _rendezvous_pick
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.metrics import Counter, get_or_create

# Replica failures the router fails over; everything else (user exceptions,
# timeouts) surfaces to the caller untouched.
RETRYABLE_ERRORS = (ActorDiedError, ActorUnavailableError)

BACKOFF_MULTIPLIER = 2.0
BACKOFF_MAX_S = 2.0
# Planned drain migrations don't consume the retry budget (rolling drains
# could legitimately move one long stream several times), but they are
# capped so a pathological all-replicas-draining loop still terminates.
DRAIN_RETRY_CAP = 32


class _RequestContext:
    """Per-request failover state shared between the router and the
    response object: what to re-submit, where it must not go again, and how
    much retry budget is left."""

    __slots__ = (
        "method_name",
        "args",
        "kwargs",
        "model_id",
        "excluded",
        "failures",
        "drains",
        "overloads",
        "retry_after_s",
        "tag",
        "affinity_key",
    )

    def __init__(self, method_name: str, args: tuple, kwargs: dict, model_id: str):
        self.method_name = method_name
        self.args = args
        self.kwargs = kwargs
        self.model_id = model_id
        self.excluded: set[str] = set()
        self.failures = 0
        self.drains = 0  # planned drain migrations (budget-exempt)
        self.overloads = 0  # bounded-admission sheds (budget-exempt)
        self.retry_after_s = 0.0  # largest retry-after hint among sheds
        self.tag: Optional[str] = None  # replica serving the latest attempt
        # Replica-affinity key (deployment's affinity_key_fn over the
        # request payload, e.g. the prompt's leading block-chain hash);
        # None = plain p2c. Computed once at assign() and reused verbatim
        # across failover re-dispatches.
        self.affinity_key: Optional[Any] = None


class DeploymentResponse:
    """Future-like wrapper over the underlying ObjectRef (reference:
    serve/handle.py DeploymentResponse). Retries on replica death by asking
    the router for a fresh dispatch within the request's retry budget."""

    def __init__(self, ref: ObjectRef, router: "Router" = None,
                 ctx: _RequestContext = None):
        self._ref = ref
        self._router = router
        self._ctx = ctx

    @property
    def replica_tag(self) -> Optional[str]:
        return self._ctx.tag if self._ctx is not None else None

    def result(self, timeout_s: Optional[float] = None) -> Any:
        from ray_tpu_torch import api as ray
        from ray_tpu_torch.exceptions import GetTimeoutError

        # In-flight accounting settles via the router's on_sealed callback
        # when the reply lands — nothing to do here beyond the get. The
        # timeout is ONE deadline across every failover attempt, not a
        # fresh budget per retry.
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while True:
            remaining = (
                None if deadline is None else deadline - time.monotonic()
            )
            if remaining is not None and remaining <= 0:
                raise GetTimeoutError(
                    f"request to {self._ctx.method_name if self._ctx else '?'}"
                    f" did not complete within {timeout_s}s (incl. failover)"
                )
            try:
                return ray.get(self._ref, timeout=remaining)
            except RETRYABLE_ERRORS as exc:
                if self._router is None or self._ctx is None:
                    raise
                delay = self._router.plan_retry(self._ctx, exc)
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        raise GetTimeoutError(
                            f"request did not complete within {timeout_s}s "
                            "(incl. failover)"
                        ) from exc
                    delay = min(delay, left)  # never sleep past the deadline
                time.sleep(delay)
                self._ref = self._router.dispatch(self._ctx, stream=False)

    def __await__(self):
        # Async ingress path: `await handle.remote(...)` resolves without
        # blocking a thread (the underlying ObjectRef registers a seal
        # callback on the running loop).
        if self._router is None or self._ctx is None:
            return self._ref.__await__()
        return self._await_with_failover().__await__()

    async def _await_with_failover(self):
        import asyncio

        while True:
            try:
                return await self._ref
            except RETRYABLE_ERRORS as exc:
                delay = self._router.plan_retry(self._ctx, exc)
                await asyncio.sleep(delay)
                loop = asyncio.get_event_loop()
                self._ref = await loop.run_in_executor(
                    None, self._router.dispatch, self._ctx, False
                )

    def _to_object_ref(self) -> ObjectRef:
        return self._ref


_PENDING = object()  # executor-poll slice expired with no item yet


class DeploymentResponseGenerator:
    """Streaming response: iterates the replica generator's items (sync or
    async), one object per yield (reference: serve handle's
    DeploymentResponseGenerator over StreamingObjectRefGenerator).

    With a `resume_fn`, a replica dying mid-stream fails over: the items
    already delivered are folded into a re-submitted request on another
    replica and the stream continues where it stopped. `resume_fn(args,
    kwargs, items) -> (args, kwargs) | None` returns the re-submission (or
    None when the stream was in fact already complete)."""

    def __init__(self, ref_gen, router: "Router" = None,
                 ctx: _RequestContext = None,
                 resume_fn: Optional[Callable] = None):
        self._gen = ref_gen
        self._router = router
        self._ctx = ctx
        self._resume_fn = resume_fn
        # Delivered items are retained only when a resume_fn needs them to
        # build the re-submission; otherwise just count them.
        self._items: list = []
        self._num_delivered = 0

    def _record(self, item) -> None:
        self._num_delivered += 1
        if self._resume_fn is not None:
            self._items.append(item)

    @property
    def replica_tag(self) -> Optional[str]:
        return self._ctx.tag if self._ctx is not None else None

    def cancel(self) -> None:
        """Stop the replica-side generator at its next yield. Called by the
        proxy on deadline/client-disconnect (the reference proxy cancels on
        disconnect) so an abandoned stream doesn't keep the replica's
        max_concurrent_queries slot pinned: the aborted stream completes,
        its completion ref seals, and the router releases the slot."""
        from ray_tpu_torch import api as ray

        try:
            ray.cancel(self._gen._completion_ref)
        except Exception:
            pass  # runtime tearing down: the stream dies with it

    def _plan_resume(self, exc: BaseException) -> Optional[float]:
        """Prepare a mid-stream failover. Returns the backoff delay to
        sleep before re-dispatching, or None when resume_fn reports the
        stream already complete. Re-raises `exc` when failover can't keep
        the stream contiguous, and ReplicaUnavailableRetryExhausted when
        the retry budget is spent."""
        if self._router is None or self._ctx is None:
            raise exc
        if self._num_delivered and self._resume_fn is None:
            # Items were already delivered and there is no way to re-submit
            # just the suffix: replaying from scratch would duplicate them.
            raise exc
        if self._resume_fn is not None:
            # Consulted even with ZERO delivered items: a stream that died
            # (or was drain-interrupted) before its first item may already
            # have state server-side — for LLM requests the original
            # engine request can still be draining under the caller's
            # pinned request_id, so a verbatim re-dispatch would collide
            # with it (llm_stream_resume re-keys the re-submission; the
            # orphan's abort races free of the retry).
            resumed = self._resume_fn(
                self._ctx.args, self._ctx.kwargs, list(self._items)
            )
            if resumed is None:
                # The stream was in fact complete (e.g. the replica died
                # after the final token): end cleanly WITHOUT burning
                # retry budget or excluding a replica.
                return None
            delay = self._router.plan_retry(self._ctx, exc)
            self._ctx.args, self._ctx.kwargs = resumed
            self._router.note_stream_resume()
            # Items already folded into the re-submission must not be
            # folded again by a later failover: the next resume is
            # relative to the updated args.
            self._items = []
            return delay
        return self._router.plan_retry(self._ctx, exc)

    def __iter__(self):
        from ray_tpu_torch import api as ray

        while True:
            try:
                for ref in self._gen:
                    item = ray.get(ref)
                    self._record(item)
                    yield item
                return
            except RETRYABLE_ERRORS as exc:
                delay = self._plan_resume(exc)
                if delay is None:
                    return
                time.sleep(delay)
                self._gen = self._router.dispatch(self._ctx, stream=True)

    def __aiter__(self):
        return self._agen()

    async def _agen(self):
        import asyncio

        loop = asyncio.get_event_loop()
        while True:
            try:
                while True:
                    # Short-sliced executor polls: a stalled stream never
                    # parks a shared executor thread for long (0.2s max), so
                    # concurrent streams timeshare the pool and a cancelled
                    # consumer leaks at most one slice of thread time.
                    ref = await loop.run_in_executor(None, self._poll_next)
                    if ref is None:
                        return
                    if ref is _PENDING:
                        continue
                    item = await ref
                    self._record(item)
                    yield item
            except RETRYABLE_ERRORS as exc:
                delay = self._plan_resume(exc)
                if delay is None:
                    return
                await asyncio.sleep(delay)
                self._gen = await loop.run_in_executor(
                    None, self._router.dispatch, self._ctx, True
                )

    def _poll_next(self):
        from ray_tpu_torch._private.streaming import _SENTINEL

        try:
            ref = self._gen._stream.next(timeout=0.2)
        except TimeoutError:
            return _PENDING
        return None if ref is _SENTINEL else ref


class Router:
    """Client-side replica selection: power-of-two-choices over in-flight
    counts, respecting max_concurrent_queries (reference router.py:338-367
    blocks awaiting a free replica or a config update)."""

    METRICS_PUSH_PERIOD_S = 0.25

    def __init__(
        self,
        app: str,
        deployment: str,
        max_concurrent_queries: int,
        retry_budget: Optional[int] = None,
        backoff_initial_s: Optional[float] = None,
        backoff_jitter_seed: Optional[int] = None,
    ):
        self._app = app
        self._deployment = deployment
        self._max_q = max_concurrent_queries
        self._retry_budget = (
            DEFAULT_RETRY_BUDGET if retry_budget is None else retry_budget
        )
        self._backoff_initial_s = (
            DEFAULT_BACKOFF_INITIAL_S
            if backoff_initial_s is None
            else backoff_initial_s
        )
        # Backoff jitter RNG: private instance, never the module-global
        # random (whose state any library may touch). The seed knob exists
        # for tests that need reproducible delays; production leaves it
        # None — decorrelated retry times are the entire point.
        self._rng = random.Random(backoff_jitter_seed)
        self._handle_id = uuid.uuid4().hex[:12]
        # Failover observability (the behavior alone shipped with no
        # metrics): every router shares one registered counter per name,
        # with the deployment as the series tag.
        self._dep_tags = {"deployment": deployment}
        self._m_retries = get_or_create(
            Counter,
            "serve_router_retry_dispatches",
            "Failover re-dispatches after a retryable replica failure",
            tag_keys=("deployment",),
        )
        self._m_excluded = get_or_create(
            Counter,
            "serve_router_excluded_replicas",
            "Replica exclusions recorded against failing requests",
            tag_keys=("deployment",),
        )
        self._m_resumes = get_or_create(
            Counter,
            "serve_router_stream_resumes",
            "Mid-stream failovers resumed via a stream_resume_fn",
            tag_keys=("deployment",),
        )
        self._m_exhausted = get_or_create(
            Counter,
            "serve_router_retry_exhausted",
            "Requests that spent their retry budget "
            "(ReplicaUnavailableRetryExhausted)",
            tag_keys=("deployment",),
        )
        self._m_drain_migrations = get_or_create(
            Counter,
            "serve_router_drain_migrations",
            "Requests re-dispatched (or streams resumed) off a DRAINING "
            "replica — planned migrations, exempt from the retry budget",
            tag_keys=("deployment",),
        )
        self._m_overloads = get_or_create(
            Counter,
            "serve_router_overload_redispatches",
            "Requests re-dispatched after a replica shed them under "
            "bounded admission (EngineOverloadedError) — routing signals, "
            "exempt from the retry budget",
            tag_keys=("deployment",),
        )
        self._m_fleet_overloaded = get_or_create(
            Counter,
            "serve_router_fleet_overloaded",
            "Requests surfaced as FleetOverloadedError after every live "
            "replica shed them",
            tag_keys=("deployment",),
        )
        self._lock = threading.Condition()
        self._replicas: dict[str, Any] = {}
        self._in_flight: dict[str, int] = {}
        from collections import OrderedDict

        # model id -> replica tag (LRU-bounded; guarded by self._lock)
        self._model_affinity: "OrderedDict[str, str]" = OrderedDict()
        self._version = -1
        self._queued = 0
        self._closed = False
        self._runtime = get_runtime()
        self._refresh()
        self._poller = threading.Thread(
            target=self._poll_loop, daemon=True, name=f"router-{deployment}"
        )
        self._poller.start()

    # ---------------- replica set maintenance ----------------

    def _controller(self):
        from ray_tpu_torch.serve._private.controller import get_controller

        controller = get_controller()
        if controller is None:
            raise RuntimeError("Serve is not running: no controller")
        return controller

    def _refresh(self, timeout: Optional[float] = None) -> None:
        from ray_tpu_torch import api as ray

        version, replicas = ray.get(
            self._controller().get_replica_snapshot.remote(
                self._app, self._deployment
            ),
            timeout=timeout,
        )
        with self._lock:
            self._version = version
            self._replicas = replicas
            for tag in replicas:
                self._in_flight.setdefault(tag, 0)
            for tag in list(self._in_flight):
                if tag not in replicas:
                    del self._in_flight[tag]
            self._lock.notify_all()

    def _runtime_current(self) -> bool:
        """False once the runtime this router was built on has shut down
        or been replaced. The poll thread then ends: polling on would keep
        the old runtime, its actors and the card memory of their engines
        alive, and would start a controller in a later runtime."""
        from ray_tpu_torch import api as ray

        return ray.is_initialized() and get_runtime() is self._runtime

    def _poll_loop(self) -> None:
        from ray_tpu_torch import api as ray

        last_push = 0.0
        while not self._closed and self._runtime_current():
            try:
                # Snapshot the version under the lock: _refresh writes it
                # under self._lock, and a torn read here would long-poll
                # with a stale version and miss one replica-set update
                # (found by lint RTL201).
                with self._lock:
                    known_version = self._version
                new_version = ray.get(
                    self._controller().listen_for_change.remote(
                        known_version, 1.0
                    ),
                    timeout=5.0,
                )
                if new_version != known_version:
                    # Bounded like the long poll: a controller killed in
                    # the middle of the call (serve.shutdown) must not park
                    # this thread past its runtime's end.
                    self._refresh(timeout=5.0)
                now = time.monotonic()
                if now - last_push > self.METRICS_PUSH_PERIOD_S:
                    with self._lock:
                        queued = self._queued + sum(self._in_flight.values())
                    # ray-tpu: lint-ignore[RTL401] metrics push is
                    # fire-and-forget by design: losing one sample is
                    # harmless and the poll loop must never block on the
                    # controller
                    self._controller().record_handle_metrics.remote(
                        self._app, self._deployment, self._handle_id, queued
                    )
                    last_push = now
            except Exception:
                if self._closed or not self._runtime_current():
                    return
                time.sleep(0.2)

    # ---------------- request path ----------------

    def assign(
        self,
        method_name: str,
        args: tuple,
        kwargs: dict,
        multiplexed_model_id: str = "",
        stream: bool = False,
        resume_fn: Optional[Callable] = None,
        affinity_key_fn: Optional[Callable] = None,
    ):
        ctx = _RequestContext(method_name, args, kwargs, multiplexed_model_id)
        if affinity_key_fn is not None:
            # Computed once per request, before the first dispatch; a
            # failing/opaque extractor degrades to plain p2c routing.
            try:
                ctx.affinity_key = affinity_key_fn(args, kwargs)
            except Exception:
                ctx.affinity_key = None
        result = self.dispatch(ctx, stream)
        if stream:
            return DeploymentResponseGenerator(
                result, router=self, ctx=ctx, resume_fn=resume_fn
            )
        return DeploymentResponse(result, router=self, ctx=ctx)

    def dispatch(self, ctx: _RequestContext, stream: bool):
        """Pick a replica and submit `ctx`'s request; a submit-time replica
        failure backs off and retries within the request's budget. Returns
        the raw ObjectRef (or ref generator for streams).

        A re-dispatch after a failure (ctx.failures > 0 — submit-time
        retries, response-side failover, and mid-stream resumes all funnel
        through here) is wrapped in a "serve.retry" span, so the retried
        replica task shows up in the trace as a child of the retry, sibling
        to the failed attempt."""
        while True:
            span = (
                tracing.span(
                    "serve.retry",
                    {
                        "deployment": self._deployment,
                        "method": ctx.method_name,
                        "attempt": ctx.failures,
                    },
                )
                if ctx.failures
                else contextlib.nullcontext()
            )
            try:
                with span:
                    return self._dispatch_once(ctx, stream)
            except RETRYABLE_ERRORS as exc:
                time.sleep(self.plan_retry(ctx, exc))

    def plan_retry(self, ctx: _RequestContext, exc: BaseException) -> float:
        """Account one failed dispatch attempt: exclude the replica it
        landed on and compute the exponential backoff delay. Raises the
        typed ReplicaUnavailableRetryExhausted once the budget is spent.

        A ReplicaDrainingError is a PLANNED migration, not a failure: the
        draining replica is excluded and the request re-dispatched after
        one short backoff (enough for the long-poll refresh of the shrunk
        replica set to land), without consuming the retry budget a real
        replica death may still need.

        An EngineOverloadedError is a bounded-admission shed — likewise a
        routing signal, not a failure: the shedding replica is excluded
        and exactly the OTHER live replicas are worth one try each (a
        different replica may front an engine with headroom). Once every
        live replica has shed the request, retrying harder is the
        queueing-collapse failure mode this control plane exists to
        prevent — surface the typed FleetOverloadedError carrying the
        engines' retry-after hint so the CALLER backs off, instead of
        buffering or burning the retry budget a replica death may need."""
        if ctx.tag is not None and ctx.tag not in ctx.excluded:
            ctx.excluded.add(ctx.tag)
            self._m_excluded.inc(tags=self._dep_tags)
        if isinstance(exc, EngineOverloadedError):
            ctx.overloads += 1
            hint = float(getattr(exc, "retry_after_s", 0.0) or 0.0)
            ctx.retry_after_s = max(ctx.retry_after_s, hint)
            with self._lock:
                num_live = len(self._replicas)
            if ctx.overloads >= max(num_live, 1):
                self._m_fleet_overloaded.inc(tags=self._dep_tags)
                raise FleetOverloadedError(
                    deployment=self._deployment,
                    attempts=ctx.failures + ctx.overloads,
                    retry_after_s=ctx.retry_after_s or self._backoff_initial_s,
                    last_error=exc,
                ) from exc
            self._m_overloads.inc(tags=self._dep_tags)
            return self._backoff_initial_s
        if isinstance(exc, ReplicaDrainingError) and ctx.drains < DRAIN_RETRY_CAP:
            ctx.drains += 1
            self._m_drain_migrations.inc(tags=self._dep_tags)
            return self._backoff_initial_s
        ctx.failures += 1
        if ctx.failures > self._retry_budget:
            self._m_exhausted.inc(tags=self._dep_tags)
            raise ReplicaUnavailableRetryExhausted(
                deployment=self._deployment,
                attempts=ctx.failures,
                last_error=exc,
            ) from exc
        self._m_retries.inc(tags=self._dep_tags)
        # FULL jitter (uniform over [0, exponential cap]), not a raw
        # exponential ladder: correlated failures put N callers on the
        # SAME deterministic retry schedule, so every wave re-arrives in
        # lockstep and re-saturates the replica that just came back.
        # Sampling the whole interval decorrelates the waves; the
        # expected delay halves, but the budgeted worst case (cap) and
        # the ladder's growth rate are unchanged.
        cap = min(
            self._backoff_initial_s * BACKOFF_MULTIPLIER ** (ctx.failures - 1),
            BACKOFF_MAX_S,
        )
        return self._rng.uniform(0.0, cap)

    def note_stream_resume(self) -> None:
        """One mid-stream failover actually resumed (items already
        delivered were folded into a re-submission)."""
        self._m_resumes.inc(tags=self._dep_tags)

    def _dispatch_once(self, ctx: _RequestContext, stream: bool):
        with self._lock:
            self._queued += 1
            prefer = (
                self._model_affinity.get(ctx.model_id)
                if ctx.model_id
                else None
            )
        try:
            tag, handle = self._pick_replica(
                prefer=prefer,
                excluded=ctx.excluded,
                affinity_key=ctx.affinity_key,
            )
        finally:
            with self._lock:
                self._queued -= 1
        if ctx.model_id:
            # Cache-affinity: later requests for this model prefer the
            # replica that just (presumably) loaded it. LRU-bounded; recency
            # refreshed on every assignment.
            with self._lock:
                self._model_affinity[ctx.model_id] = tag
                self._model_affinity.move_to_end(ctx.model_id)
                while len(self._model_affinity) > 256:
                    self._model_affinity.popitem(last=False)
        ctx.tag = tag
        if stream:
            try:
                gen = handle.handle_request_streaming.options(
                    num_returns="streaming"
                ).remote(ctx.method_name, ctx.args, ctx.kwargs, ctx.model_id)
            except BaseException:
                self._on_done(tag)
                ctx.excluded.add(tag)
                raise

            # In-flight settles when the generator COMPLETES (the completion
            # ref seals after the last yield).
            def _on_stream_done(_ref=gen._completion_ref, _tag=tag):
                self._on_done(_tag)

            get_runtime().store.on_sealed(
                gen._completion_ref.id, _on_stream_done
            )
            return gen
        try:
            ref = handle.handle_request.remote(
                ctx.method_name, ctx.args, ctx.kwargs, ctx.model_id
            )
        except BaseException:
            self._on_done(tag)
            ctx.excluded.add(tag)
            raise

        # Decrement in-flight when the REPLY arrives, not when the caller
        # reads it — fire-and-forget .remote() must not pin slots forever
        # (reference router decrements on task completion). The closure holds
        # the ref so a dropped DeploymentResponse can't delete the reply
        # object (and with it this callback) before the reply is sealed.
        def _on_reply(_ref=ref, _tag=tag):
            self._on_done(_tag)

        get_runtime().store.on_sealed(ref.id, _on_reply)
        return ref

    def _pick_replica(
        self,
        timeout_s: float = 30.0,
        prefer: str = None,
        excluded: frozenset = frozenset(),
        affinity_key=None,
    ):
        # Monotonic deadline: an NTP step while blocked here would stretch
        # or truncate the replica wait arbitrarily (found by lint RTL302).
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while True:
                available = [
                    (tag, h)
                    for tag, h in self._replicas.items()
                    if self._in_flight.get(tag, 0) < self._max_q
                ]
                # Skip replicas this request already failed on — but when
                # every live replica is excluded, forgive rather than hang:
                # a later attempt on an excluded-but-alive replica beats
                # blocking until the pick times out.
                candidates = [
                    th for th in available if th[0] not in excluded
                ] or available
                if candidates:
                    if prefer is None and affinity_key is not None:
                        # Prefix/content affinity: rendezvous-hash over the
                        # live NON-EXCLUDED replica set (not the capacity-
                        # filtered candidates — a momentary full queue must
                        # not remap the key), then honored only if that
                        # replica is an eligible candidate below. Layered
                        # strictly as a tie-break: drain/exclusion filtered
                        # first, capacity still decides, p2c is the
                        # fallback — affinity never overrides any of them.
                        live = sorted(
                            t for t in self._replicas if t not in excluded
                        ) or sorted(self._replicas)
                        prefer = _rendezvous_pick(affinity_key, live)
                    # Model-affinity: take the preferred replica when it has
                    # capacity (multiplexing cache locality).
                    if prefer is not None:
                        for tag, h in candidates:
                            if tag == prefer:
                                self._in_flight[tag] = (
                                    self._in_flight.get(tag, 0) + 1
                                )
                                return tag, h
                    # Random sample doubles as a random TIE-BREAK: with a
                    # deterministic order, N fresh routers (all counts 0)
                    # would all pick the same first replica and pile a
                    # whole burst onto it.
                    candidates = random.sample(
                        candidates, min(len(candidates), 2)
                    )
                    tag, h = min(
                        candidates, key=lambda th: self._in_flight.get(th[0], 0)
                    )
                    self._in_flight[tag] = self._in_flight.get(tag, 0) + 1
                    return tag, h
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"No available replica for {self._deployment} within "
                        f"{timeout_s}s"
                    )
                self._lock.wait(min(remaining, 0.5))

    def _on_done(self, tag: str) -> None:
        with self._lock:
            if tag in self._in_flight and self._in_flight[tag] > 0:
                self._in_flight[tag] -= 1
            self._lock.notify_all()

    def close(self) -> None:
        self._closed = True


class _RouterCell:
    """Shared lazy slot for one Router, held by every handle derived from
    the same root with unchanged retry knobs. Without it, each
    `handle.options(...)` on a handle whose router was not yet created
    built its OWN router on first use — N concurrent streams from fresh
    per-request handles then carried N independent in-flight tables
    (and N poll threads), and the power-of-two choice degenerated to
    "everyone's counts are zero, everyone picks the same first replica":
    a whole burst piled onto one replica of a balanced pair."""

    __slots__ = ("router", "lock")

    def __init__(self, router: Optional[Router] = None):
        self.router = router
        self.lock = threading.Lock()


class DeploymentHandle:
    """User-facing handle: `handle.remote(...)` / `handle.method.remote(...)`
    (reference: serve/handle.py:74)."""

    def __init__(
        self,
        app: str,
        deployment: str,
        max_concurrent_queries: int = 100,
        method_name: str = "__call__",
        multiplexed_model_id: str = "",
        stream: bool = False,
        _router: Optional[Router] = None,
        retry_budget: Optional[int] = None,
        backoff_initial_s: Optional[float] = None,
        stream_resume_fn: Optional[Callable] = None,
        _router_cell: Optional[_RouterCell] = None,
        affinity_key_fn: Optional[Callable] = None,
        backoff_jitter_seed: Optional[int] = None,
    ):
        self._app = app
        self._deployment = deployment
        self._max_q = max_concurrent_queries
        self._method_name = method_name
        self._model_id = multiplexed_model_id
        self._stream = stream
        self._router_cell = _router_cell or _RouterCell(_router)
        self._retry_budget = retry_budget
        self._backoff_initial_s = backoff_initial_s
        self._backoff_jitter_seed = backoff_jitter_seed
        self._stream_resume_fn = stream_resume_fn
        self._affinity_key_fn = affinity_key_fn

    @property
    def _router(self) -> Optional[Router]:
        return self._router_cell.router

    def _get_router(self) -> Router:
        cell = self._router_cell
        if cell.router is None:
            # Double-checked under the cell lock: concurrent first
            # requests (the loadgen open-loop burst) must share ONE
            # router, not race N into existence.
            with cell.lock:
                if cell.router is None:
                    cell.router = Router(
                        self._app,
                        self._deployment,
                        self._max_q,
                        retry_budget=self._retry_budget,
                        backoff_initial_s=self._backoff_initial_s,
                        backoff_jitter_seed=self._backoff_jitter_seed,
                    )
        return cell.router

    def remote(self, *args, **kwargs):
        return self._get_router().assign(
            self._method_name, args, kwargs, self._model_id,
            stream=self._stream, resume_fn=self._stream_resume_fn,
            affinity_key_fn=self._affinity_key_fn,
        )

    def options(
        self,
        method_name: Optional[str] = None,
        multiplexed_model_id: Optional[str] = None,
        stream: Optional[bool] = None,
        retry_budget: Optional[int] = None,
        backoff_initial_s: Optional[float] = None,
        stream_resume_fn: Optional[Callable] = None,
        affinity_key_fn: Optional[Callable] = None,
        backoff_jitter_seed: Optional[int] = None,
    ) -> "DeploymentHandle":
        changed_router_cfg = (
            retry_budget is not None
            or backoff_initial_s is not None
            or backoff_jitter_seed is not None
        )
        h = DeploymentHandle(
            self._app,
            self._deployment,
            self._max_q,
            method_name if method_name is not None else self._method_name,
            multiplexed_model_id
            if multiplexed_model_id is not None
            else self._model_id,
            stream if stream is not None else self._stream,
            # Retry knobs live on the Router, so a shared router (cell)
            # can't be reused when they change. The CELL is shared — not
            # just an already-built router — so per-request options()
            # handles converge on one router even when the first of them
            # races the root's lazy creation.
            _router_cell=None if changed_router_cfg else self._router_cell,
            retry_budget=retry_budget
            if retry_budget is not None
            else self._retry_budget,
            backoff_initial_s=backoff_initial_s
            if backoff_initial_s is not None
            else self._backoff_initial_s,
            stream_resume_fn=stream_resume_fn
            if stream_resume_fn is not None
            else self._stream_resume_fn,
            affinity_key_fn=affinity_key_fn
            if affinity_key_fn is not None
            else self._affinity_key_fn,
            backoff_jitter_seed=backoff_jitter_seed
            if backoff_jitter_seed is not None
            else self._backoff_jitter_seed,
        )
        return h

    def __getattr__(self, item: str):
        if item.startswith("_"):
            raise AttributeError(item)
        return self.options(method_name=item)

    def __reduce__(self):
        # Handles are serializable into replicas/tasks; router rebuilds lazily.
        return (
            _rebuild_handle,
            (
                self._app,
                self._deployment,
                self._max_q,
                self._method_name,
                self._model_id,
                self._stream,
                self._retry_budget,
                self._backoff_initial_s,
                self._stream_resume_fn,
                self._affinity_key_fn,
                self._backoff_jitter_seed,
            ),
        )

    def __repr__(self):
        return f"DeploymentHandle({self._app}#{self._deployment})"


def _rebuild_handle(
    app,
    deployment,
    max_q,
    method_name,
    model_id,
    stream,
    retry_budget=None,
    backoff_initial_s=None,
    stream_resume_fn=None,
    affinity_key_fn=None,
    backoff_jitter_seed=None,
) -> DeploymentHandle:
    return DeploymentHandle(
        app,
        deployment,
        max_q,
        method_name,
        model_id,
        stream,
        retry_budget=retry_budget,
        backoff_initial_s=backoff_initial_s,
        stream_resume_fn=stream_resume_fn,
        affinity_key_fn=affinity_key_fn,
        backoff_jitter_seed=backoff_jitter_seed,
    )
