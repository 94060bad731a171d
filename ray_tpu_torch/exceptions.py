"""Exceptions of the runtime and the serving engine.

The classes keep the reference package's names, hierarchy and pickling
contract (`__reduce__` carries every payload field, so a result that crosses
the object store by pickle keeps its ids and causes).
"""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """Wraps an exception raised by user task code.

    Stored as the task's result object; re-raised (with the remote traceback
    appended) when the ref is `get`-ed — matching the reference's RayTaskError
    (python/ray/exceptions.py).
    """

    def __init__(self, cause: BaseException, traceback_str: str = "", task_name: str = ""):
        self.cause = cause
        self.traceback_str = traceback_str
        self.task_name = task_name
        super().__init__(f"Task {task_name or '<unknown>'} failed: {cause!r}\n{traceback_str}")

    def as_instanceof_cause(self) -> BaseException:
        """Return an exception that is an instance of the cause's class, so
        `except ValueError:` at the call site catches a remote ValueError
        (reference: RayTaskError.as_instanceof_cause). Built as a dynamic
        subclass of both TaskError and the cause's class; falls back to
        self when the cause's class cannot be subclassed (e.g. BaseException
        subclasses with incompatible layouts)."""
        cause = self.cause
        if isinstance(cause, TaskError):
            return cause
        cause_cls = type(cause)
        if isinstance(self, cause_cls):
            return self
        try:
            derived = type(
                f"TaskError({cause_cls.__name__})",
                (TaskError, cause_cls),
                {"__module__": "ray_tpu_torch.exceptions"},
            )
            # Assemble the instance WITHOUT running __init__: on the diamond
            # class, TaskError.__init__'s super().__init__(message) would
            # dispatch to the cause class's __init__ with the message string,
            # clobbering its payload (e.g. PoisonRequestError.request_id).
            instance = derived.__new__(derived)
            instance.args = (str(self),)
            # Carry the cause's payload so `except CauseType as e:` sees the
            # same attributes as a local raise — except the fields TaskError
            # itself owns, which keep wrapper semantics (cause = the remote
            # exception) so chained wrap/unwrap hops stay type-stable.
            for key, value in vars(cause).items():
                if key not in ("cause", "traceback_str", "task_name"):
                    instance.__dict__[key] = value
            instance.cause = cause
            instance.traceback_str = self.traceback_str
            instance.task_name = self.task_name
            return instance
        except TypeError:
            return self

    def __reduce__(self):
        # Exceptions cross the object store by pickle, and the default
        # reduce calls cls(args[0]) — wrong for this signature, and
        # impossible for the dynamic TaskError(CauseType) subclasses (their
        # class doesn't exist on the other side). Rebuild from the payload
        # instead (reference: RayTaskError's dual-exception machinery).
        if type(self) is TaskError:
            return (TaskError, (self.cause, self.traceback_str, self.task_name))
        return (
            _rebuild_derived_task_error,
            (self.cause, self.traceback_str, self.task_name),
        )


def _rebuild_derived_task_error(
    cause: BaseException, traceback_str: str, task_name: str
) -> BaseException:
    return TaskError(cause, traceback_str, task_name).as_instanceof_cause()


class ActorError(RayTpuError):
    pass


class ActorDiedError(ActorError):
    def __init__(self, actor_id=None, reason: str = "actor died"):
        self.actor_id = actor_id
        super().__init__(reason)

    def __reduce__(self):
        # Default reduce would call ActorDiedError(message), silently
        # shifting the reason into actor_id on every store round-trip.
        return (ActorDiedError, (self.actor_id, str(self)))


class ActorUnavailableError(ActorError):
    pass


class ReplicaDrainingError(ActorUnavailableError):
    """A Serve replica marked DRAINING rejected a new dispatch, or
    interrupted an in-flight stream at its drain deadline. Subclasses
    ActorUnavailableError so the router's existing failover path
    re-dispatches (and, for streams with a stream_resume_fn,
    stream-resumes) onto a surviving replica WITHOUT waiting for the
    draining replica to actually die — the router additionally treats it
    as a planned migration rather than a failure, so it never consumes
    the request's retry budget."""


class EngineOverloadedError(ActorUnavailableError):
    """Bounded admission rejected a submission: the engine's scheduler
    backlog is at its configured cap (EngineConfig.max_queue_len /
    max_queue_tokens), or the request's deadline had already passed at
    submission. Subclasses ActorUnavailableError so the router's existing
    failover machinery re-dispatches onto another replica — like
    ReplicaDrainingError, a shed is a routing signal, not a failure.
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


class FleetOverloadedError(ActorError):
    """Every replica the router could reach shed the request
    (EngineOverloadedError from each): the fleet as a whole is past its
    admission caps. Terminal and typed — the router surfaces this instead
    of buffering the request or burning its retry budget redialing
    replicas that have already said no. `retry_after_s` is the largest
    hint any replica offered; callers should back off at least that long
    before resubmitting."""

    def __init__(
        self,
        deployment: str = "",
        attempts: int = 0,
        retry_after_s: float = 0.0,
        last_error: "BaseException | None" = None,
    ):
        self.deployment = deployment
        self.attempts = attempts
        self.retry_after_s = retry_after_s
        self.last_error = last_error
        super().__init__(
            f"deployment {deployment!r} is overloaded: every replica shed "
            f"the request across {attempts} dispatch attempt(s); retry "
            f"after {retry_after_s:.3f}s. Last error: {last_error!r}"
        )

    def __reduce__(self):
        return (
            FleetOverloadedError,
            (
                self.deployment,
                self.attempts,
                self.retry_after_s,
                self.last_error,
            ),
        )


class ReplicaUnavailableRetryExhausted(ActorError):
    """The Serve router's client-side failover gave up: every dispatch of a
    request within its retry budget landed on a dead/unavailable replica.
    Carries the attempt count and the last underlying error so callers see
    a typed failure instead of a raw ActorDiedError."""

    def __init__(
        self,
        deployment: str = "",
        attempts: int = 0,
        last_error: "BaseException | None" = None,
    ):
        self.deployment = deployment
        self.attempts = attempts
        self.last_error = last_error
        super().__init__(
            f"request to deployment {deployment!r} failed after {attempts} "
            f"dispatch attempt(s); last error: {last_error!r}"
        )

    def __reduce__(self):
        return (
            ReplicaUnavailableRetryExhausted,
            (self.deployment, self.attempts, self.last_error),
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


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"Task {task_id} was cancelled")

    def __reduce__(self):
        return (TaskCancelledError, (self.task_id,))


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly (reference:
    python/ray/exceptions.py WorkerCrashedError). A system failure: always
    consumes a retry regardless of retry_exceptions."""



class ObjectLostError(RayTpuError):
    def __init__(self, object_id=None, reason: str = "object lost"):
        self.object_id = object_id
        super().__init__(reason)

    def __reduce__(self):
        return (type(self), (self.object_id, str(self)))


class ObjectFreedError(ObjectLostError):
    pass


class OwnerDiedError(ObjectLostError):
    pass


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class OutOfResourcesError(RayTpuError):
    """No node in the cluster can ever satisfy the request (infeasible)."""


class PlacementGroupError(RayTpuError):
    pass

