"""Replica actor: hosts one copy of a deployment's user callable.

Reference: serve/_private/replica.py (RayServeReplica.handle_request) — the
replica is a plain actor; the router talks to it directly (CS5 in SURVEY.md).
Concurrency comes from the actor's max_concurrency thread pool, bounded
client-side by max_concurrent_queries.
"""

from __future__ import annotations

import asyncio
import inspect
import threading
import time
from typing import Any

from ray_tpu_torch._private.fault_injection import maybe_fail
from ray_tpu_torch.exceptions import ReplicaDrainingError
from ray_tpu_torch.util import tracing


class ReplicaActor:
    """One replica of a deployment.

    Created by the controller with the user class/function (cloudpickled via
    normal actor-arg serialization), init args, and user_config.

    Drain protocol (controller scale-down): `drain(timeout_s)` marks the
    replica DRAINING — new dispatches are refused with the retryable
    ReplicaDrainingError (the router re-dispatches them; the routing set
    already shrank via the long-poll bump, so only racing dispatches hit
    this), in-flight requests keep running, and streams still unfinished
    at the drain deadline are interrupted with the same typed error so the
    router stream-resumes them on surviving replicas instead of waiting
    for the kill's ActorDiedError.
    """

    def __init__(
        self,
        deployment_name: str,
        replica_tag: str,
        callable_def: Any,
        init_args: tuple,
        init_kwargs: dict,
        user_config: Any = None,
        collect_autoscaling_metrics: bool = False,
    ):
        self._deployment_name = deployment_name
        self._replica_tag = replica_tag
        self._lock = threading.Lock()
        self._num_ongoing = 0
        self._num_processed = 0
        # Set by the controller for deployments under an SLO autoscaling
        # policy: get_metrics then also collects the callable's
        # autoscaling_metrics() — deployments that don't autoscale on SLO
        # signals never pay the hook's cost.
        self._collect_autoscaling = bool(collect_autoscaling_metrics)
        self._draining = False
        self._drain_deadline: float = 0.0  # monotonic; valid iff draining
        self._num_drain_interrupted = 0
        # Monotonic: uptime_s is a duration, and wall-clock steps would
        # make it jump (or go negative) in the metrics.
        self._start_time = time.monotonic()

        if inspect.isclass(callable_def):
            self._callable = callable_def(*init_args, **init_kwargs)
        else:
            # Function deployment: the "callable" is the function itself.
            self._callable = callable_def
        if user_config is not None:
            self.reconfigure(user_config)

    def reconfigure(self, user_config: Any) -> None:
        """Apply a new user_config without restarting (reference:
        serve/_private/replica.py reconfigure → user class's `reconfigure`)."""
        fn = getattr(self._callable, "reconfigure", None)
        if fn is None:
            if inspect.isclass(type(self._callable)) and not inspect.isfunction(
                self._callable
            ):
                # Classes receiving user_config must define reconfigure.
                raise ValueError(
                    f"Deployment {self._deployment_name} got user_config but "
                    "its class defines no reconfigure() method"
                )
            return
        result = fn(user_config)
        if inspect.iscoroutine(result):
            asyncio.run(result)

    # ---------------- drain protocol ----------------

    def drain(self, timeout_s: float) -> bool:
        """Controller scale-down hook: refuse new work, give in-flight
        requests up to `timeout_s` to finish, interrupt streams after
        (chaos site: replica.drain). Idempotent; returns True."""
        maybe_fail(
            "replica.drain",
            detail=f"{self._deployment_name}:{self._replica_tag}",
        )
        with self._lock:
            self._draining = True
            self._drain_deadline = time.monotonic() + max(float(timeout_s), 0.0)
        return True

    def _reject_if_draining(self) -> None:
        with self._lock:
            draining = self._draining
        if draining:
            raise ReplicaDrainingError(
                f"replica {self._replica_tag} of {self._deployment_name} is "
                "draining; re-dispatch to a surviving replica"
            )

    def _drain_interrupt_due(self) -> bool:
        with self._lock:
            return (
                self._draining
                and time.monotonic() >= self._drain_deadline
            )

    def _drain_interrupt(self, user_gen: Any) -> "ReplicaDrainingError":
        """Account one stream interrupted at the drain deadline and close
        the user generator FIRST, so its finally-cleanup (e.g. the LLM
        ingress's engine abort, which frees the request's KV and
        draft-mirror blocks) runs before the client's resume re-submits
        the suffix elsewhere. Returns the error to raise."""
        with self._lock:
            self._num_drain_interrupted += 1
        close = getattr(user_gen, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass  # cleanup best-effort; the kill path would be worse
        return ReplicaDrainingError(
            f"replica {self._replica_tag} of {self._deployment_name} "
            "interrupted this stream at its drain deadline; resume on a "
            "surviving replica"
        )

    # ---------------- request paths ----------------

    def handle_request(
        self,
        method_name: str,
        args: tuple,
        kwargs: dict,
        multiplexed_model_id: str = "",
    ) -> Any:
        from ray_tpu_torch.serve.multiplex import _set_multiplexed_model_id

        maybe_fail(
            "replica.handle_request",
            detail=f"{self._deployment_name}:{self._replica_tag}:{method_name}",
        )
        self._reject_if_draining()
        with self._lock:
            self._num_ongoing += 1
        token = _set_multiplexed_model_id(multiplexed_model_id)
        try:
            if method_name == "__call__":
                target = self._callable
            else:
                target = getattr(self._callable, method_name)
            # User-callable execution time as its own span (the enclosing
            # task span also covers argument resolution and queueing);
            # submissions made inside the callable nest under it.
            with tracing.span(
                "serve.replica.request",
                {
                    "deployment": self._deployment_name,
                    "replica": self._replica_tag,
                    "method": method_name,
                },
            ):
                result = target(*args, **kwargs)
                if inspect.iscoroutine(result):
                    result = asyncio.run(result)
            return result
        finally:
            from ray_tpu_torch.serve.multiplex import _multiplexed_model_id

            _multiplexed_model_id.reset(token)
            with self._lock:
                self._num_ongoing -= 1
                self._num_processed += 1

    def handle_request_streaming(
        self,
        method_name: str,
        args: tuple,
        kwargs: dict,
        multiplexed_model_id: str = "",
    ):
        """Generator variant: the user callable returns a (sync) generator
        and each yielded item is sealed as its own object for the caller's
        ObjectRefGenerator (reference: replica.py handle_request_streaming
        → StreamingObjectRefGenerator)."""
        from ray_tpu_torch.serve.multiplex import _set_multiplexed_model_id

        maybe_fail(
            "replica.handle_request_streaming",
            detail=f"{self._deployment_name}:{self._replica_tag}:{method_name}",
        )
        self._reject_if_draining()
        with self._lock:
            self._num_ongoing += 1
        token = _set_multiplexed_model_id(multiplexed_model_id)
        # Stream processing span, emitted with an EXPLICIT parent at the
        # end (a `with` span inside a generator would reset contextvars
        # from whatever thread happens to finalize the frame).
        span_parent = tracing.capture_context()
        span_start = time.time()
        n_items = 0
        try:
            if method_name == "__call__":
                target = self._callable
            else:
                target = getattr(self._callable, method_name)
            result = target(*args, **kwargs)
            if inspect.iscoroutine(result):
                result = asyncio.run(result)
            if inspect.isasyncgen(result):
                # Async-generator deployments: drain on a private loop so
                # each yielded value becomes a stream item.
                loop = asyncio.new_event_loop()
                try:
                    while True:
                        if self._drain_interrupt_due():
                            try:
                                loop.run_until_complete(result.aclose())
                            except Exception:
                                pass
                            raise self._drain_interrupt(None)
                        try:
                            item = loop.run_until_complete(result.__anext__())
                        except StopAsyncIteration:
                            break
                        n_items += 1
                        yield item
                finally:
                    loop.close()
                return
            if not hasattr(result, "__iter__") or isinstance(
                result, (str, bytes, dict)
            ):
                n_items = 1
                yield result  # non-iterable: a one-item stream
                return
            it = iter(result)
            while True:
                # A drain deadline interrupts BETWEEN items: delivered
                # tokens stay delivered (the resume folds them into the
                # re-submission), the user generator's cleanup runs here
                # — not at some later GC — and the raised typed error is
                # what the router migrates on.
                if self._drain_interrupt_due():
                    raise self._drain_interrupt(result)
                try:
                    item = next(it)
                except StopIteration:
                    break
                # Chaos hook: die mid-stream after a deterministic number of
                # items (simulates a replica lost between yields).
                maybe_fail(
                    "replica.stream_item",
                    detail=f"{self._deployment_name}:{self._replica_tag}",
                )
                n_items += 1
                yield item
        finally:
            from ray_tpu_torch.serve.multiplex import _multiplexed_model_id

            tracing.emit_span(
                "serve.replica.stream",
                span_start,
                time.time(),
                parent=span_parent,
                attributes={
                    "deployment": self._deployment_name,
                    "replica": self._replica_tag,
                    "method": method_name,
                    "items": n_items,
                },
            )
            _multiplexed_model_id.reset(token)
            with self._lock:
                self._num_ongoing -= 1
                self._num_processed += 1

    def get_metrics(self) -> dict:
        with self._lock:
            out = {
                "replica_tag": self._replica_tag,
                "num_ongoing_requests": self._num_ongoing,
                "num_processed": self._num_processed,
                "draining": self._draining,
                "num_drain_interrupted": self._num_drain_interrupted,
                "uptime_s": time.monotonic() - self._start_time,
            }
        # Autoscaling hook: a callable exposing autoscaling_metrics()
        # (e.g. LLMIngress forwarding the engine's SLO histogram windows)
        # rides the controller's existing metrics poll — one RPC, no
        # second polling plane. Failures never fail the poll.
        fn = (
            getattr(self._callable, "autoscaling_metrics", None)
            if self._collect_autoscaling
            else None
        )
        if fn is not None:
            try:
                snap = fn()
                if isinstance(snap, dict) and snap:
                    out["autoscaling"] = snap
            except Exception:
                pass
        return out

    def check_health(self) -> bool:
        fn = getattr(self._callable, "check_health", None)
        if fn is not None:
            result = fn()
            if inspect.iscoroutine(result):
                result = asyncio.run(result)
            return bool(result) if result is not None else True
        return True

    def prepare_for_shutdown(self) -> None:
        fn = getattr(self._callable, "__del__", None)
        # Graceful shutdown hook (reference: replica.py prepare_for_shutdown).
        hook = getattr(self._callable, "shutdown", None)
        if hook is not None:
            try:
                result = hook()
                if inspect.iscoroutine(result):
                    asyncio.run(result)
            except Exception:
                pass
