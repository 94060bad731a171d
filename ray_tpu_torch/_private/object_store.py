"""Host object store: immutable objects keyed by ObjectID.

The reference splits objects between a per-worker in-process memory store (small
objects / error signals) and the node-wide plasma shared-memory store
(src/ray/object_manager/plasma/, embedded in the raylet). This module provides the
same interface against a single in-process table — the engine of the threaded
runtime — with large values in the native shared-memory store
(native_store.py) and spilling to external storage (external_storage.py) as
in the reference, and the locations of values whose bytes live in a remote
node's store (`seal_remote`), pulled through the runtime's remote fetch.

Semantics preserved from plasma (object_store.h / object_lifecycle_manager.h):
  * objects are create-once, sealed, then immutable;
  * readers block until seal (`get` with timeout);
  * delete is initiated by the owner's reference counter, never by readers;
  * memory accounting with a budget; sealing beyond the budget evicts
    unreferenced objects LRU-first, then spills referenced ones to external
    storage, else raises OutOfMemoryError.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Callable, Iterable

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch.exceptions import GetTimeoutError, ObjectFreedError, ObjectLostError


class OutOfMemoryError(MemoryError):
    pass


def _sizeof(value: Any) -> int:
    """Approximate in-memory footprint; exact for numpy/torch/bytes,
    best-effort else (a dict of tensors counts as the dict alone, as in the
    reference)."""
    try:
        import numpy as np

        if isinstance(value, np.ndarray):
            return value.nbytes
    except ImportError:
        pass
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
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
        "in_native",
        "spilled_uri",
        "nested_refs",
        "remote_node",
        "extra_locations",
    )

    def __init__(self):
        self.value = None
        self.size = 0
        self.sealed = False
        self.freed = False
        self.event = threading.Event()
        self.last_access = 0.0
        self.callbacks: list[Callable[[], None]] = []
        self.in_native = False
        self.spilled_uri: str | None = None
        # ObjectRef handles serialized inside this value (borrows): held for
        # the entry's lifetime so the inner objects can't be collected.
        self.nested_refs: list | None = None
        # Bytes live in a remote node's local store (reference: the object
        # directory, ownership_based_object_directory.h — the owner records
        # locations, readers pull). None = bytes are local (or not sealed).
        self.remote_node = None
        # Nodes holding CACHED copies (completed pulls): later pullers
        # spread across these, making a 1-to-N broadcast scale like the
        # reference's chunked push tree (object_manager/push_manager.h).
        self.extra_locations: set | None = None


class InProcessStore:
    """Thread-safe in-process object table with plasma-like lifecycle.

    Large objects are delegated to the native shared-memory store
    (csrc/store.cc via native_store.py) when one is attached:
    the python table keeps the lifecycle (seal events, callbacks, budget),
    shm keeps the bytes, and `get` deserializes zero-copy views."""

    def __init__(
        self,
        memory_budget: int | None = None,
        native=None,
        native_threshold: int = 0,
        spill_storage=None,
        serialize: bool = True,
    ):
        self._serialize = serialize
        self._lock = threading.Lock()
        self._entries: dict[ObjectID, _Entry] = {}
        self._budget = memory_budget
        self._used = 0
        self._native = native
        self._native_threshold = native_threshold if native is not None else 0
        self._spill = spill_storage
        # Objects the reference counter still holds references to may not be
        # evicted; the runtime installs this callback.
        self._pinned_check: Callable[[ObjectID], bool] = lambda oid: True
        self._remote_fetch = None  # installed via set_remote_fetch

    def set_pinned_check(self, fn: Callable[[ObjectID], bool]) -> None:
        self._pinned_check = fn

    def set_remote_fetch(self, fn) -> None:
        """Install the cross-node pull: fn(object_id, node_id) returns the
        materialized value after (optionally) caching bytes locally, or
        raises ObjectLostError. Installed by the runtime when remote nodes
        exist (reference: PullManager, object_manager/pull_manager.h)."""
        self._remote_fetch = fn

    # -- write path ---------------------------------------------------------

    def seal(self, object_id: ObjectID, value: Any) -> None:
        """Create-and-seal in one step (the in-process store has no partial create)."""
        from ray_tpu_torch._private.object_ref import capture_serialized_refs

        size = _sizeof(value)
        in_native = False
        nested: list = []
        # Entries evicted while we hold the lock are parked here so their
        # nested_refs (whose GC re-enters this store via the refcounter) are
        # dropped only after the lock is released.
        dropped: list = []
        if self._native_threshold and size >= self._native_threshold:
            # Serialize into shm before taking the table lock (expensive);
            # idempotent reseal is handled natively (-1 == exists).
            try:
                with capture_serialized_refs(nested):
                    self._native.put_object(object_id, value)
                self._native.pin(object_id)  # owner pin: not LRU-evictable
                in_native = True
                value = None
            except MemoryError:
                nested.clear()
                pass  # shm full: keep the python copy
        if not in_native and self._serialize:
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
                # A first value already in shm is the payload put_object
                # found there: drop only the pin just taken (the reference
                # deletes it, which strands the first value's readers).
                if in_native:
                    if entry.in_native:
                        self._native.release(object_id)
                    else:
                        self._native.unpin_and_delete(object_id)
                return
            # shm-resident bytes are governed by the shm capacity/LRU, not the
            # python-side budget — account them at zero here so they can't
            # trigger spurious in-process eviction/spilling pressure.
            if in_native:
                size = 0
            if self._budget is not None and self._used + size > self._budget:
                self._evict_locked(self._used + size - self._budget, dropped)
            entry.value = value
            entry.size = size
            entry.sealed = True
            entry.freed = False
            entry.in_native = in_native
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
            entry.in_native = False
            entry.nested_refs = nested_refs
            entry.last_access = time.monotonic()
            self._used += size
            entry.event.set()
            callbacks, entry.callbacks = entry.callbacks, []
        for cb in callbacks:
            cb()

    def get_serialized(self, object_id: ObjectID) -> bytes | None:
        """The sealed value's serialized bytes, if held in-process as
        _Pickled (None for native/spilled/live-stored values) — lets a
        worker's get be answered with the bytes as they are, without a
        decode and re-encode."""
        with self._lock:
            entry = self._entries.get(object_id)
            if (
                entry is None
                or not entry.sealed
                or entry.freed
                or entry.spilled_uri is not None
                or entry.in_native
            ):
                return None
            entry.last_access = time.monotonic()
            value = entry.value
            return value.data if isinstance(value, _Pickled) else None

    def seal_native(
        self, object_id: ObjectID, size: int, nested_refs: list | None = None
    ) -> bool:
        """Adopt an object a worker process already wrote+sealed in the shared
        shm store: pin it owner-side and mark the table entry sealed without
        re-serializing (process-isolation return path). Returns False if the
        object is not actually resident in shm."""
        if self._native is None:
            return False
        if not self._native.pin(object_id):
            return False
        fire = False
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                entry = _Entry()
                self._entries[object_id] = entry
            if entry.sealed:
                # Idempotent reseal on task retry: keep the first copy, drop
                # the extra pin we just took.
                self._native.release(object_id)
                return True
            entry.value = None
            entry.size = 0  # shm bytes are accounted by the shm store
            entry.sealed = True
            entry.freed = False
            entry.in_native = True
            entry.nested_refs = nested_refs
            entry.last_access = time.monotonic()
            entry.event.set()
            callbacks, entry.callbacks = entry.callbacks, []
            fire = True
        if fire:
            for cb in callbacks:
                cb()
        return True

    def seal_remote(
        self,
        object_id: ObjectID,
        node_id,
        size: int,
        nested_refs: list | None = None,
    ) -> None:
        """Record that a worker on a remote node produced+sealed this object
        into that node's local store: the owner keeps the location, not the
        bytes. Reads pull through the remote-fetch hook on demand."""
        fire = False
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                entry = _Entry()
                self._entries[object_id] = entry
            if entry.sealed:
                return  # idempotent reseal on retry: keep the first copy
            entry.value = None
            entry.size = 0  # bytes accounted by the remote node's store
            entry.sealed = True
            entry.freed = False
            entry.in_native = False
            entry.remote_node = node_id
            entry.nested_refs = nested_refs
            entry.last_access = time.monotonic()
            entry.event.set()
            callbacks, entry.callbacks = entry.callbacks, []
            fire = True
        if fire:
            for cb in callbacks:
                cb()

    def location_of(self, object_id: ObjectID):
        """The remote node holding this sealed object's bytes, or None when
        the bytes are local/unsealed (the owner-directed location lookup)."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None or not entry.sealed or entry.freed:
                return None
            return entry.remote_node

    def add_location(self, object_id: ObjectID, node_id) -> None:
        """Record a node now holding a cached copy of this object."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None or not entry.sealed or entry.freed:
                return
            if entry.extra_locations is None:
                entry.extra_locations = set()
            entry.extra_locations.add(node_id)

    def locations_of(self, object_id: ObjectID) -> list:
        """All nodes known to hold this object's bytes: the producer first,
        then cached copies."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None or not entry.sealed or entry.freed:
                return []
            out = []
            if entry.remote_node is not None:
                out.append(entry.remote_node)
            if entry.extra_locations:
                out.extend(
                    n for n in entry.extra_locations if n != entry.remote_node
                )
            return out

    def drop_node_locations(self, node_id) -> None:
        """Forget every cached copy on a dead node (primary copies are
        handled by the lost-object path)."""
        with self._lock:
            for entry in self._entries.values():
                if entry.extra_locations:
                    entry.extra_locations.discard(node_id)

    def adopt_fetched(
        self, object_id: ObjectID, value: Any, pickled: bytes | None = None
    ) -> None:
        """Cache a remotely-fetched object's bytes locally so later reads
        skip the network: converts a remote-located entry in place. Subject
        to the same budget/eviction as seal — pulls must not grow memory
        past the budget."""
        dropped: list = []
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None or not entry.sealed or entry.remote_node is None:
                return
            if pickled is not None:
                size = len(pickled)
                new_value: Any = _Pickled(pickled)
            else:
                size = _sizeof(value)
                new_value = value
            if self._budget is not None and self._used + size > self._budget:
                self._evict_locked(self._used + size - self._budget, dropped)
            entry.value = new_value
            entry.size = size
            entry.last_access = time.monotonic()
            self._used += size
            entry.remote_node = None
        del dropped  # nested_refs GC outside the lock

    def adopt_fetched_native(self, object_id: ObjectID) -> bool:
        """Flip a remote-located entry to shm-resident after its envelope
        bytes were written into the local native store. Returns False if the
        pin failed (raced an eviction)."""
        if self._native is None or not self._native.pin(object_id):
            return False
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None or not entry.sealed or entry.remote_node is None:
                self._native.release(object_id)
                return True
            entry.in_native = True
            entry.remote_node = None
        return True

    def invalidate(self, object_id: ObjectID) -> None:
        """Reset a lost object's entry to the unsealed state so the lineage
        re-execution's reseal can land and readers re-block on the event
        (reference: ObjectRecoveryManager marking objects as being
        reconstructed, object_recovery_manager.h:42)."""
        dropped: list = []
        was_native = False
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None or not entry.sealed:
                return
            if entry.spilled_uri is None and not entry.in_native:
                self._used -= entry.size
            was_native = entry.in_native
            dropped.append((entry.value, entry.nested_refs))
            entry.value = None
            entry.size = 0
            entry.sealed = False
            entry.freed = False
            entry.in_native = False
            entry.spilled_uri = None
            entry.nested_refs = None
            entry.remote_node = None
            entry.event.clear()
        if was_native and self._native is not None:
            # Drop the owner pin so the shm payload doesn't leak; with reader
            # pins outstanding the shared delete_pending bit completes it.
            self._native.unpin_and_delete(object_id)

    def is_available(self, object_id: ObjectID) -> bool:
        """Cheap availability probe WITHOUT materializing: sealed and its
        bytes are actually reachable (in-memory, spill file exists, or shm
        contains it). Used by recovery to avoid deserializing healthy deps."""
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None or not entry.sealed or entry.freed:
                return False
            spilled_uri = entry.spilled_uri
            in_native = entry.in_native
        if spilled_uri is not None:
            import os as _os

            return _os.path.exists(spilled_uri)
        if in_native:
            return self._native is not None and self._native.contains(object_id)
        return True

    def was_freed(self, object_id: ObjectID) -> bool:
        """True if the object was explicitly freed (never recoverable)."""
        with self._lock:
            entry = self._entries.get(object_id)
            return entry is not None and entry.freed

    def is_native(self, object_id: ObjectID) -> bool:
        """True if the sealed object's bytes live in the shared shm store."""
        with self._lock:
            entry = self._entries.get(object_id)
            return entry is not None and entry.sealed and entry.in_native

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
                spilled_uri = entry.spilled_uri
                in_native = entry.in_native
                value = entry.value
                remote_node = entry.remote_node
                break
        if remote_node is not None:
            # Pull through the cross-node hook (which caches locally and may
            # flip the entry to in_native/_Pickled; raises ObjectLostError on
            # a dead node / evicted copy, triggering lineage recovery).
            if self._remote_fetch is None:
                raise ObjectLostError(
                    object_id,
                    f"Object {object_id} lives on node {remote_node} but no "
                    "remote fetch path is installed",
                )
            return self._remote_fetch(object_id, remote_node)
        if spilled_uri is None and not in_native:
            if not isinstance(value, _Pickled):
                return value
            # Deserialize outside the lock: a fresh copy per reader.
            import cloudpickle

            return cloudpickle.loads(value.data)
        if spilled_uri is not None:
            # Restore from disk outside the lock. The value is returned
            # without re-admitting it to the in-memory table (reads hit disk
            # until memory pressure clears and a reseal happens naturally).
            try:
                restored = self._spill.restore(spilled_uri)
                if isinstance(restored, _Pickled):
                    import cloudpickle

                    return cloudpickle.loads(restored.data)
                return restored
            except FileNotFoundError:
                # Distinguish a racing free() (it clears spilled_uri and
                # unlinks AFTER we captured the uri) from external file loss:
                # freed objects must NOT be resurrected by lineage recovery.
                with self._lock:
                    if entry.freed or entry.spilled_uri != spilled_uri:
                        raise ObjectFreedError(
                            object_id, f"Object {object_id} was freed"
                        ) from None
                raise ObjectLostError(
                    object_id, f"Spill file for {object_id} is missing"
                ) from None
        # Deserialize outside the lock; numpy arrays come back as read-only
        # views pinning the shm object until they are garbage collected,
        # tensors as copies of their own (ROADMAP.md §D24).
        found, value = self._native.get_object(object_id)
        if not found:
            raise ObjectLostError(object_id, f"Object {object_id} lost from shm")
        return value

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
        natives = []
        spilled = []
        dropped = []  # keeps popped entries alive until the lock is released
        with self._lock:
            for oid in object_ids:
                entry = self._entries.pop(oid, None)
                if entry is None:
                    continue
                dropped.append(entry)
                if entry.sealed:
                    if entry.spilled_uri is not None:
                        spilled.append(entry.spilled_uri)
                    else:
                        self._used -= entry.size
                    if entry.in_native:
                        natives.append(oid)
        for oid in natives:
            self._native.unpin_and_delete(oid)
        for uri in spilled:
            self._spill.delete(uri)

    def free(self, object_ids: Iterable[ObjectID]) -> None:
        """Mark freed: later `get`s raise ObjectFreedError (ray.internal.free)."""
        fired: list[Callable[[], None]] = []
        natives = []
        spilled = []
        dropped = []  # nested-ref lists die outside the lock
        with self._lock:
            for oid in object_ids:
                entry = self._entries.get(oid)
                if entry is not None:
                    if entry.sealed and entry.spilled_uri is None:
                        self._used -= entry.size
                    entry.size = 0  # a later delete() must not re-subtract
                    if entry.spilled_uri is not None:
                        spilled.append(entry.spilled_uri)
                        entry.spilled_uri = None
                    if entry.in_native:
                        natives.append(oid)
                        entry.in_native = False
                    # Park both the live value and the nested refs: either may
                    # hold the last ObjectRef handle to another object, whose
                    # __del__ re-enters this store via the refcounter.
                    dropped.append((entry.value, entry.nested_refs))
                    entry.value = None
                    entry.freed = True
                    entry.nested_refs = None
                    entry.remote_node = None
                    entry.event.set()
                    fired.extend(entry.callbacks)
                    entry.callbacks = []
        for oid in natives:
            self._native.unpin_and_delete(oid)
        for uri in spilled:
            self._spill.delete(uri)
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
        when everything left is referenced, primary copies spill to external
        storage instead of failing (local_object_manager.h SpillObjects) —
        their refs stay valid and `get` restores from disk."""
        candidates = sorted(
            (
                (entry.last_access, oid, entry)
                for oid, entry in self._entries.items()
                if entry.sealed
                and not entry.freed
                and entry.spilled_uri is None  # spilled: no resident bytes
                and not entry.in_native  # shm bytes: governed by shm's own LRU
                and entry.remote_node is None  # bytes live on a remote node
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
            if entry.in_native:
                # Called under the lock; the native delete takes only the shm
                # mutex, no re-entry into this store.
                self._native.unpin_and_delete(oid)
                entry.in_native = False
            # Park value AND nested refs off-lock; clearing nested_refs here
            # matters: an evicted (unreadable) object must not keep pinning
            # the inner objects its bytes referenced.
            dropped.append((entry, entry.value, entry.nested_refs))
            entry.value = None
            entry.nested_refs = None
            entry.freed = True
            entry.event.set()
            del self._entries[oid]
        if reclaimed >= need_bytes:
            return
        if self._spill is not None:
            spill_candidates = sorted(
                (
                    (entry.last_access, oid, entry)
                    for oid, entry in self._entries.items()
                    if entry.sealed
                    and not entry.freed
                    and not entry.in_native
                    and entry.remote_node is None
                    and entry.spilled_uri is None
                ),
                key=lambda item: item[0],
            )
            for _, oid, entry in spill_candidates:
                if reclaimed >= need_bytes:
                    break
                # Spill IO under the lock: correctness over concurrency for
                # the pressure path (the reference offloads to IO workers).
                entry.spilled_uri = self._spill.spill(oid, entry.value)
                dropped.append(entry.value)  # live value destructs off-lock
                entry.value = None
                reclaimed += entry.size
                self._used -= entry.size
        if reclaimed < need_bytes:
            raise OutOfMemoryError(
                f"Object store over budget: need {need_bytes} more bytes but only "
                f"{reclaimed} reclaimable (evictable + spillable)"
            )

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    @property
    def num_objects(self) -> int:
        with self._lock:
            return sum(1 for e in self._entries.values() if e.sealed and not e.freed)
