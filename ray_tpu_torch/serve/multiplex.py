"""Model multiplexing — many models per deployment, LRU-cached per replica.

Reference: serve/multiplex.py (_ModelMultiplexWrapper) + serve/api.py
`@serve.multiplexed` and `serve.get_multiplexed_model_id()`: a deployment
serves N models from one replica pool; requests carry a model id
(`handle.options(multiplexed_model_id=...)`), the replica loads the model on
first use through the user's decorated loader, keeps an LRU of
`max_num_models_per_replica`, and the router prefers replicas that already
hold the model (cache-affinity routing).
"""

from __future__ import annotations

import asyncio
import contextvars
import inspect
import threading
from collections import OrderedDict
from typing import Any, Callable, Optional

_multiplexed_model_id: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_serve_multiplexed_model_id", default=""
)


def _run_coroutine(coro) -> Any:
    """Run an async loader to completion whether or not this thread already
    has a running event loop (async deployments execute inside asyncio.run)."""
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return asyncio.run(coro)
    # Inside a running loop: block on a worker thread's fresh loop (the
    # deployment method awaits nothing meanwhile — same semantics as a
    # synchronous load).
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as pool:
        return pool.submit(asyncio.run, coro).result()


def get_multiplexed_model_id() -> str:
    """Inside a deployment method: the model id of the current request."""
    return _multiplexed_model_id.get()


def _set_multiplexed_model_id(model_id: str):
    return _multiplexed_model_id.set(model_id)


class _ModelMultiplexWrapper:
    """Bound-method wrapper holding the per-replica LRU of loaded models."""

    def __init__(self, loader: Callable, owner: Any, max_models: int):
        self._loader = loader
        self._owner = owner
        self._max = max_models
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()
        # Per-model in-progress guard: concurrent first requests for the same
        # model must load it once (loads are expensive — often device memory).
        self._loading: dict = {}

    def _evict_locked(self) -> None:
        while len(self._models) > self._max:
            _, model = self._models.popitem(last=False)
            # Best-effort unload hook. Deliberately NOT __del__: calling a
            # dunder finalizer explicitly makes the GC run it a second time
            # at refcount zero (double-free for device buffers).
            fn = getattr(model, "unload", None)
            if fn is not None:
                try:
                    fn()
                except Exception:
                    pass

    def __call__(self, model_id: Optional[str] = None) -> Any:
        model_id = model_id or get_multiplexed_model_id()
        if not model_id:
            raise ValueError(
                "No multiplexed model id: call with an explicit id or send "
                "the request via handle.options(multiplexed_model_id=...)"
            )
        while True:
            with self._lock:
                if model_id in self._models:
                    self._models.move_to_end(model_id)
                    return self._models[model_id]
                loading = self._loading.get(model_id)
                if loading is None:
                    self._loading[model_id] = threading.Event()
                    break  # we load
            loading.wait(timeout=300.0)
        try:
            result = self._loader(self._owner, model_id)
            if inspect.iscoroutine(result):
                result = _run_coroutine(result)
            with self._lock:
                self._models[model_id] = result
                self._models.move_to_end(model_id)
                self._evict_locked()
            return result
        finally:
            with self._lock:
                event = self._loading.pop(model_id, None)
            if event is not None:
                event.set()

    def loaded_models(self) -> list:
        with self._lock:
            return list(self._models)


_DESCRIPTOR_LOCK = threading.Lock()


class _MultiplexedDescriptor:
    """Descriptor so `self.get_model` resolves to one wrapper per instance."""

    def __init__(self, loader: Callable, max_models: int):
        self._loader = loader
        self._max = max_models
        self._attr = f"_multiplex_wrapper_{id(self)}"

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        wrapper = getattr(obj, self._attr, None)
        if wrapper is None:
            # Replicas call methods from a thread pool: exactly one wrapper
            # per instance, or concurrent first requests each build their own
            # LRU and double-load every model.
            with _DESCRIPTOR_LOCK:
                wrapper = getattr(obj, self._attr, None)
                if wrapper is None:
                    wrapper = _ModelMultiplexWrapper(self._loader, obj, self._max)
                    setattr(obj, self._attr, wrapper)
        return wrapper


def multiplexed(max_num_models_per_replica: int = 3):
    """Decorator for the model-loader method of a multiplexed deployment:

        @serve.deployment
        class Model:
            @serve.multiplexed(max_num_models_per_replica=3)
            async def get_model(self, model_id: str): ...

            async def __call__(self, x):
                model = await... self.get_model()  # current request's model
    """

    def decorator(loader: Callable):
        return _MultiplexedDescriptor(loader, max_num_models_per_replica)

    return decorator
