"""Exceptions the serving engine raises, trimmed to what the port uses.

The classes keep the reference package's names, hierarchy and pickling
contract (`__reduce__` carries every payload field, so a result that crosses
a process boundary by pickle keeps its ids and causes).
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


class ActorError(RayTpuError):
    pass


class ActorUnavailableError(ActorError):
    pass


class EngineOverloadedError(ActorUnavailableError):
    """Bounded admission rejected a submission: the engine's scheduler
    backlog is at its configured cap (EngineConfig.max_queue_len /
    max_queue_tokens), or the request's deadline had already passed at
    submission. A shed is a routing signal, not a failure.
    `retry_after_s` is the engine's hint for when capacity is likely to
    return (a rough queue-drain estimate, never a guarantee)."""

    def __init__(
        self,
        engine: str = "",
        reason: str = "queue full",
        queue_len: int = 0,
        retry_after_s: float = 0.0,
    ):
        self.engine = engine
        self.reason = reason
        self.queue_len = queue_len
        self.retry_after_s = retry_after_s
        super().__init__(
            f"engine {engine or '<unknown>'} shed the request: {reason} "
            f"(queue_len={queue_len}, retry_after_s={retry_after_s:.3f})"
        )

    def __reduce__(self):
        return (
            EngineOverloadedError,
            (self.engine, self.reason, self.queue_len, self.retry_after_s),
        )


class PoisonRequestError(RayTpuError):
    """One serving request caused an engine step exception and was failed in
    isolation (dead-lettered); the engine itself kept serving the other
    in-flight requests. `request_id` identifies the culprit and `cause` is
    the original step exception."""

    def __init__(
        self,
        request_id: str = "",
        reason: str = "",
        cause: "BaseException | None" = None,
    ):
        self.request_id = request_id
        self.reason = reason
        self.cause = cause
        super().__init__(
            f"request {request_id or '<unknown>'} poisoned the engine step: "
            f"{reason or cause!r}"
        )

    def __reduce__(self):
        return (
            PoisonRequestError,
            (self.request_id, self.reason, self.cause),
        )
