"""ObjectRef handle — the user-facing future (reference: ObjectRef in _raylet.pyx).

Constructing a handle takes a local reference in the ownership table; GC of the
handle releases it (reference_count.h AddLocalReference/RemoveLocalReference via
core_worker.h:434,442). Because the threaded runtime shares one refcount table,
handles embedded in stored values keep their reference alive through ordinary
Python object liveness — the borrow protocol for the in-process engine.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

from ray_tpu_torch._private.ids import ObjectID

_CAPTURE = threading.local()


@contextlib.contextmanager
def capture_serialized_refs(out: list):
    """Collect every ObjectRef serialized while the context is active.

    The store wraps seal-time serialization with this so a ref nested inside a
    stored value is an explicit borrow: the entry holds the captured handles,
    keeping the inner object alive for the outer object's lifetime
    (reference: ReferenceCounter nested-object sets, reference_count.h)."""
    prev = getattr(_CAPTURE, "refs", None)
    _CAPTURE.refs = out
    try:
        yield out
    finally:
        _CAPTURE.refs = prev


def _global_runtime():
    from ray_tpu_torch._private import runtime as runtime_mod

    return runtime_mod._RUNTIME


class ObjectRef:
    __slots__ = ("_id", "_owner_hint", "__weakref__")

    def __init__(self, object_id: ObjectID, _incref: bool = True):
        self._id = object_id
        self._owner_hint = None
        if _incref:
            rt = _global_runtime()
            if rt is not None:
                rt.refcount.add_local_reference(object_id)

    @property
    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def task_id(self):
        return self._id.task_id

    def __del__(self):
        try:
            rt = _global_runtime()
            if rt is not None and not rt.shutting_down:
                rt.refcount.remove_local_reference(self._id)
        except Exception:
            pass

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other._id == self._id

    def __hash__(self):
        return hash(self._id)

    def __repr__(self):
        return f"ObjectRef({self._id.hex()})"

    def __reduce__(self):
        refs = getattr(_CAPTURE, "refs", None)
        if refs is not None:
            refs.append(self)
        # Deserialization takes its own local reference (the borrow).
        return (ObjectRef, (self._id,))

    def future(self):
        """Return a concurrent.futures.Future resolving to the object's value."""
        import concurrent.futures

        rt = _global_runtime()
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _fill():
            try:
                fut.set_result(rt.get([self], timeout=None)[0])
            except BaseException as exc:  # noqa: BLE001
                fut.set_exception(exc)

        rt.store.on_sealed(self._id, lambda: rt.background(_fill))
        return fut

    def __await__(self):
        import asyncio

        loop = asyncio.get_event_loop()
        return _to_asyncio_future(self, loop).__await__()


def _to_asyncio_future(ref: ObjectRef, loop):
    fut = loop.create_future()
    rt = _global_runtime()

    def _fill():
        def _set():
            if fut.cancelled():
                return
            try:
                fut.set_result(rt.get([ref], timeout=None)[0])
            except BaseException as exc:  # noqa: BLE001
                fut.set_exception(exc)

        loop.call_soon_threadsafe(_set)

    rt.store.on_sealed(ref._id, lambda: rt.background(_fill))
    return fut
