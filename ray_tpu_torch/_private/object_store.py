"""Host object store: immutable objects keyed by ObjectID.

The reference splits objects between a per-worker in-process memory store (small
objects / error signals) and the node-wide plasma shared-memory store
(src/ray/object_manager/plasma/, embedded in the raylet). This module provides the
same interface against a single in-process table — the engine of the threaded
runtime. The reference's shared-memory store, spilling and remote-node
locations are not ported (ROADMAP.md §B10).

Semantics preserved from plasma (object_store.h / object_lifecycle_manager.h):
  * objects are create-once, sealed, then immutable;
  * readers block until seal (`get` with timeout);
  * delete is initiated by the owner's reference counter, never by readers;
  * memory accounting with a budget; sealing beyond the budget evicts
    unreferenced objects LRU-first, else raises OutOfMemoryError.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Callable, Iterable

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.exceptions import GetTimeoutError, ObjectFreedError


class OutOfMemoryError(MemoryError):
    pass


def _sizeof(value: Any) -> int:
    """Approximate in-memory footprint; exact for numpy/bytes, best-effort else."""
    try:
        import numpy as np

        if isinstance(value, np.ndarray):
            return value.nbytes
    except ImportError:
        pass
    if isinstance(value, (bytes, bytearray, memoryview)):
        return len(value)
    return sys.getsizeof(value)


class _Pickled:
    """Sealed value held as serialized bytes: every `get` deserializes a fresh
    copy, enforcing the reference's object-immutability contract (a reader
    mutating a `get` result can never corrupt other readers). Values that
    fail to serialize are stored live as a documented escape hatch."""

    __slots__ = ("data",)

    def __init__(self, data: bytes):
        self.data = data


class _Entry:
    __slots__ = (
        "value",
        "size",
        "sealed",
        "event",
        "freed",
        "last_access",
        "callbacks",
        "nested_refs",
    )

    def __init__(self):
        self.value = None
        self.size = 0
        self.sealed = False
        self.freed = False
        self.event = threading.Event()
        self.last_access = 0.0
        self.callbacks: list[Callable[[], None]] = []
        # ObjectRef handles serialized inside this value (borrows): held for
        # the entry's lifetime so the inner objects can't be collected.
        self.nested_refs: list | None = None


class InProcessStore:
    """Thread-safe in-process object table with plasma-like lifecycle."""

    def __init__(self, memory_budget: int | None = None, serialize: bool = True):
        self._serialize = serialize
        self._lock = threading.Lock()
        self._entries: dict[ObjectID, _Entry] = {}
        self._budget = memory_budget
        self._used = 0
        # Objects the reference counter still holds references to may not be
        # evicted; the runtime installs this callback.
        self._pinned_check: Callable[[ObjectID], bool] = lambda oid: True

    def set_pinned_check(self, fn: Callable[[ObjectID], bool]) -> None:
        self._pinned_check = fn

    # -- write path ---------------------------------------------------------

    def seal(self, object_id: ObjectID, value: Any) -> None:
        """Create-and-seal in one step (the in-process store has no partial create)."""
        from ray_tpu_torch._private.object_ref import capture_serialized_refs

        size = _sizeof(value)
        nested: list = []
        # Entries evicted while we hold the lock are parked here so their
        # nested_refs (whose GC re-enters this store via the refcounter) are
        # dropped only after the lock is released.
        dropped: list = []
        if self._serialize:
            try:
                import cloudpickle

                with capture_serialized_refs(nested):
                    data = cloudpickle.dumps(value, protocol=5)
                value = _Pickled(data)
                size = len(data)
            except Exception:
                nested.clear()  # unpicklable: store live (aliasing escape hatch)
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                entry = _Entry()
                self._entries[object_id] = entry
            if entry.sealed:
                # Idempotent reseal happens on task retry; keep first value.
                return
            if self._budget is not None and self._used + size > self._budget:
                self._evict_locked(self._used + size - self._budget, dropped)
            entry.value = value
            entry.size = size
            entry.sealed = True
            entry.freed = False
            entry.nested_refs = nested or None
            entry.last_access = time.monotonic()
            self._used += size
            entry.event.set()
            callbacks, entry.callbacks = entry.callbacks, []
        for cb in callbacks:
            cb()

    def seal_pickled(
        self, object_id: ObjectID, data: bytes, nested_refs: list | None = None
    ) -> None:
        """Seal a value that is ALREADY serialized (bytes produced by a worker
        process): stored as _Pickled directly, skipping the driver-side
        re-serialization that seal() would perform."""
        dropped: list = []
        size = len(data)
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                entry = _Entry()
                self._entries[object_id] = entry
            if entry.sealed:
                return  # idempotent reseal on retry: keep the first copy
            if self._budget is not None and self._used + size > self._budget:
                self._evict_locked(self._used + size - self._budget, dropped)
            entry.value = _Pickled(data)
            entry.size = size
            entry.sealed = True
            entry.freed = False
            entry.nested_refs = nested_refs
            entry.last_access = time.monotonic()
            self._used += size
            entry.event.set()
            callbacks, entry.callbacks = entry.callbacks, []
        for cb in callbacks:
            cb()

    def get_serialized(self, object_id: ObjectID) -> bytes | None:
        """The sealed value's serialized bytes, if held as _Pickled (None for
        values stored live) — lets a worker's get be answered with the bytes
        as they are, without a decode and re-encode."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None or not entry.sealed or entry.freed:
                return None
            entry.last_access = time.monotonic()
            value = entry.value
            return value.data if isinstance(value, _Pickled) else None

    def invalidate(self, object_id: ObjectID) -> None:
        """Reset a lost object's entry to the unsealed state so the lineage
        re-execution's reseal can land and readers re-block on the event
        (reference: ObjectRecoveryManager marking objects as being
        reconstructed, object_recovery_manager.h:42)."""
        dropped: list = []
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None or not entry.sealed:
                return
            self._used -= entry.size
            dropped.append((entry.value, entry.nested_refs))
            entry.value = None
            entry.size = 0
            entry.sealed = False
            entry.freed = False
            entry.nested_refs = None
            entry.event.clear()

    def is_available(self, object_id: ObjectID) -> bool:
        """Cheap availability probe WITHOUT materializing: sealed and not
        freed. Used by recovery to avoid deserializing healthy deps."""
        with self._lock:
            entry = self._entries.get(object_id)
            return entry is not None and entry.sealed and not entry.freed

    def was_freed(self, object_id: ObjectID) -> bool:
        """True if the object was explicitly freed (never recoverable)."""
        with self._lock:
            entry = self._entries.get(object_id)
            return entry is not None and entry.freed

    def on_sealed(self, object_id: ObjectID, callback: Callable[[], None]) -> None:
        """Invoke `callback` once the object is sealed (immediately if already).

        This is the in-process analog of the raylet DependencyManager's
        object-local notifications (raylet/dependency_manager.h).
        """
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                entry = _Entry()
                self._entries[object_id] = entry
            if not entry.sealed and not entry.freed:
                entry.callbacks.append(callback)
                return
        callback()

    # -- read path ----------------------------------------------------------

    def get(self, object_id: ObjectID, timeout: float | None = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            remaining = (
                None if deadline is None else max(0.0, deadline - time.monotonic())
            )
            entry = self._wait_entry(object_id, remaining)
            # Decide the read mode ONCE under the lock — entry fields are
            # mutable and a concurrent free()/invalidate() must not flip the
            # branch mid-read.
            with self._lock:
                if entry.freed:
                    raise ObjectFreedError(
                        object_id, f"Object {object_id} was freed"
                    )
                if not entry.sealed:
                    continue  # invalidated between event-wait and lock: re-wait
                entry.last_access = time.monotonic()
                value = entry.value
                break
        if not isinstance(value, _Pickled):
            return value
        # Deserialize outside the lock: a fresh copy per reader.
        import cloudpickle

        return cloudpickle.loads(value.data)

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            entry = self._entries.get(object_id)
            return entry is not None and entry.sealed and not entry.freed

    def wait(
        self,
        object_ids: Iterable[ObjectID],
        num_returns: int,
        timeout: float | None = None,
    ) -> tuple[list[ObjectID], list[ObjectID]]:
        """Block until `num_returns` of `object_ids` are sealed (ray.wait)."""
        object_ids = list(object_ids)
        deadline = None if timeout is None else time.monotonic() + timeout
        ready: list[ObjectID] = []
        remaining: list[ObjectID] = []
        pending = list(object_ids)
        while True:
            still = []
            for oid in pending:
                if self.contains(oid) or self._is_freed(oid):
                    ready.append(oid)
                else:
                    still.append(oid)
            pending = still
            if len(ready) >= num_returns or not pending:
                break
            wait_for = 0.05
            if deadline is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                wait_for = min(wait_for, left)
            # Block on the first pending object's event (cheap wakeup heuristic).
            entry = self._ensure_entry(pending[0])
            entry.event.wait(wait_for)
        # First num_returns ready objects; everything else (including surplus
        # ready ones) stays in `remaining`, preserving input order.
        taken = set(ready[:num_returns])
        remaining = [oid for oid in object_ids if oid not in taken]
        return ready[:num_returns], remaining

    # -- delete path --------------------------------------------------------

    def delete(self, object_ids: Iterable[ObjectID]) -> None:
        dropped = []  # keeps popped entries alive until the lock is released
        with self._lock:
            for oid in object_ids:
                entry = self._entries.pop(oid, None)
                if entry is None:
                    continue
                dropped.append(entry)
                if entry.sealed:
                    self._used -= entry.size

    def free(self, object_ids: Iterable[ObjectID]) -> None:
        """Mark freed: later `get`s raise ObjectFreedError (ray.internal.free)."""
        fired: list[Callable[[], None]] = []
        dropped = []  # nested-ref lists die outside the lock
        with self._lock:
            for oid in object_ids:
                entry = self._entries.get(oid)
                if entry is not None:
                    if entry.sealed:
                        self._used -= entry.size
                    entry.size = 0  # a later delete() must not re-subtract
                    # Park both the live value and the nested refs: either may
                    # hold the last ObjectRef handle to another object, whose
                    # __del__ re-enters this store via the refcounter.
                    dropped.append((entry.value, entry.nested_refs))
                    entry.value = None
                    entry.freed = True
                    entry.nested_refs = None
                    entry.event.set()
                    fired.extend(entry.callbacks)
                    entry.callbacks = []
        for cb in fired:
            cb()

    # -- internals ----------------------------------------------------------

    def _is_freed(self, oid: ObjectID) -> bool:
        with self._lock:
            entry = self._entries.get(oid)
            return entry is not None and entry.freed

    def _ensure_entry(self, object_id: ObjectID) -> _Entry:
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                entry = _Entry()
                self._entries[object_id] = entry
            return entry

    def _wait_entry(self, object_id: ObjectID, timeout: float | None) -> _Entry:
        entry = self._ensure_entry(object_id)
        if not entry.event.wait(timeout):
            raise GetTimeoutError(
                f"Get timed out after {timeout}s waiting for {object_id}"
            )
        return entry

    def _evict_locked(self, need_bytes: int, dropped: list) -> None:
        """LRU eviction of sealed, unpinned objects (plasma eviction_policy.h);
        when everything left is referenced the seal fails (the reference
        spills instead; spilling is not ported)."""
        candidates = sorted(
            (
                (entry.last_access, oid, entry)
                for oid, entry in self._entries.items()
                if entry.sealed
                and not entry.freed
                and not self._pinned_check(oid)
            ),
            key=lambda item: item[0],
        )
        reclaimed = 0
        for _, oid, entry in candidates:
            if reclaimed >= need_bytes:
                break
            reclaimed += entry.size
            self._used -= entry.size
            # Park value AND nested refs off-lock; clearing nested_refs here
            # matters: an evicted (unreadable) object must not keep pinning
            # the inner objects its bytes referenced.
            dropped.append((entry, entry.value, entry.nested_refs))
            entry.value = None
            entry.nested_refs = None
            entry.freed = True
            entry.event.set()
            del self._entries[oid]
        if reclaimed < need_bytes:
            raise OutOfMemoryError(
                f"Object store over budget: need {need_bytes} more bytes but only "
                f"{reclaimed} reclaimable (evictable)"
            )

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    @property
    def num_objects(self) -> int:
        with self._lock:
            return sum(1 for e in self._entries.values() if e.sealed and not e.freed)
