"""Actor API (reference: python/ray/actor.py — ActorClass._remote :665,
ActorHandle._actor_method_call :1113)."""

from __future__ import annotations

import functools
from typing import Any, Optional

from ray_tpu_torch._private import options as option_utils
from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch._private.runtime import get_runtime


class ActorMethod:
    def __init__(
        self,
        actor_handle: "ActorHandle",
        method_name: str,
        num_returns: int = 1,
        name: str | None = None,
    ):
        self._handle = actor_handle
        self._method_name = method_name
        self._num_returns = num_returns
        self._name = name  # display name for the submitted task

    def options(
        self, num_returns: int | None = None, name: str | None = None
    ) -> "ActorMethod":
        return ActorMethod(
            self._handle,
            self._method_name,
            self._num_returns if num_returns is None else num_returns,
            self._name if name is None else name,
        )

    def remote(self, *args, **kwargs):
        runtime = get_runtime()
        refs = runtime.submit_actor_task(
            self._handle._actor_id,
            self._method_name,
            args,
            kwargs,
            name=self._name
            or f"{self._handle._class_name}.{self._method_name}",
            num_returns=self._num_returns,
        )
        if self._num_returns == 0:
            return None
        if self._num_returns == 1 or self._num_returns == "streaming":
            return refs[0]
        return refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method {self._method_name!r} cannot be called directly; "
            "use .remote()."
        )


class ActorHandle:
    def __init__(
        self,
        actor_id: ActorID,
        class_name: str,
        creation_ref=None,
        method_num_returns: dict[str, int] | None = None,
    ):
        self._actor_id = actor_id
        self._class_name = class_name
        # Holding the creation ref keeps constructor errors retrievable.
        self._creation_ref = creation_ref
        self._method_num_returns = method_num_returns or {}

    def __getattr__(self, item: str) -> ActorMethod:
        if item.startswith("_"):
            raise AttributeError(item)
        return ActorMethod(self, item, self._method_num_returns.get(item, 1))

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (
            _rebuild_handle,
            (self._actor_id, self._class_name, self._method_num_returns),
        )

    def _ready_ref(self):
        return self._creation_ref


def _rebuild_handle(
    actor_id: ActorID, class_name: str, method_num_returns: dict | None = None
) -> ActorHandle:
    return ActorHandle(actor_id, class_name, method_num_returns=method_num_returns)


class ActorClass:
    def __init__(self, cls: type, actor_options: dict[str, Any]):
        self._cls = cls
        self._options = option_utils.validate_actor_options(actor_options)
        functools.update_wrapper(self, cls, updated=[])

    def options(self, **actor_options) -> "ActorClass":
        merged = dict(self._options)
        merged.update(actor_options)
        return ActorClass(self._cls, merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        opts = self._options
        runtime = get_runtime()
        name = opts.get("name")
        namespace = opts.get("namespace")
        if name and opts.get("get_if_exists"):
            existing = runtime.controller.get_named_actor(
                name, namespace or runtime.namespace
            )
            if existing is not None:
                return ActorHandle(existing, self._cls.__name__)
        resources = option_utils.to_resource_request(
            opts.get("num_cpus"),
            opts.get("num_gpus"),
            opts.get("resources"),
            # Actors default to zero lifetime resources (ray_option_utils.py:
            # num_cpus defaults to 1 for creation, 0 for running; we model the
            # running cost, so unspecified means 0).
            default_num_cpus=0.0,
        )
        try:
            actor_id, creation_ref = runtime.create_actor(
                self._cls,
                args,
                kwargs,
                name=name,
                namespace=namespace,
                resources=resources,
                scheduling_strategy=opts.get("scheduling_strategy"),
                max_restarts=opts.get("max_restarts", 0),
                max_task_retries=opts.get("max_task_retries", 0),
                max_concurrency=opts.get("max_concurrency", 1),
                detached=opts.get("lifetime") == "detached",
                runtime_env=opts.get("runtime_env"),
                isolation=opts.get("isolation"),
            )
        except ValueError:
            # Name race: another creator won between our existence check and
            # registration; with get_if_exists, adopt the winner.
            if name and opts.get("get_if_exists"):
                existing = runtime.controller.get_named_actor(
                    name, namespace or runtime.namespace
                )
                if existing is not None:
                    return ActorHandle(existing, self._cls.__name__)
            raise
        method_num_returns = {
            name: getattr(fn, "__ray_tpu_num_returns__")
            for name, fn in vars(self._cls).items()
            if callable(fn) and hasattr(fn, "__ray_tpu_num_returns__")
        }
        return ActorHandle(
            actor_id, self._cls.__name__, creation_ref, method_num_returns
        )

    def bind(self, *args, **kwargs):
        """Build a lazy actor-creation DAG node (reference: dag/class_node.py)."""
        from ray_tpu_torch.dag.dag_node import ClassNode

        return ClassNode(self, args, kwargs, {})

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__!r} cannot be instantiated directly; "
            "use .remote()."
        )


def method(num_returns: int = 1):
    """Decorator recording per-method defaults (reference: ray.method)."""

    def decorator(fn):
        fn.__ray_tpu_num_returns__ = num_returns
        return fn

    return decorator
