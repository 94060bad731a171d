"""Ownership-based distributed GC.

Re-designs the reference's `ReferenceCounter` (src/ray/core_worker/reference_count.h:61)
for this runtime. The reference keeps one counter *per owner worker* and runs a
borrower long-poll protocol over pubsub (WaitForRefRemoved :893). Here all workers of a
cluster share one control plane, so the counter is a single authoritative table — the
*protocol* (what counts as a reference, when an object becomes collectible, lineage
pinning for reconstruction) is preserved; the cross-process bookkeeping is not
re-derived from gossip because it doesn't need to be.

Per-object state (mirrors `Reference` struct, reference_count.h):
  * local_ref_count   — live ObjectRef handles anywhere in the cluster
  * submitted_count   — in-flight tasks that take the object as an argument
  * lineage_count     — downstream objects whose reconstruction would re-run the
                        producing task (lineage pinning, reference_count.h:75)
  * owner_task        — task whose spec can re-create the object (lineage)

An object's *value* is deletable when local+submitted are zero; its *lineage* (task
spec) is releasable when lineage_count is also zero.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ray_tpu_torch._private.ids import ObjectID, TaskID


class _Ref:
    __slots__ = (
        "local_ref_count",
        "submitted_count",
        "lineage_count",
        "owner_task",
        "is_owned",
    )

    def __init__(self):
        self.local_ref_count = 0
        self.submitted_count = 0
        self.lineage_count = 0
        self.owner_task: Optional[TaskID] = None
        self.is_owned = False

    @property
    def out_of_scope(self) -> bool:
        return self.local_ref_count == 0 and self.submitted_count == 0


class ReferenceCounter:
    def __init__(
        self,
        on_object_out_of_scope: Callable[[ObjectID], None],
        on_lineage_released: Callable[[TaskID], None] | None = None,
        lineage_pinning_enabled: bool = True,
    ):
        self._lock = threading.RLock()
        self._refs: dict[ObjectID, _Ref] = {}
        # task_id -> object ids produced by it that still pin its lineage
        self._task_outputs: dict[TaskID, set[ObjectID]] = {}
        self._on_out_of_scope = on_object_out_of_scope
        self._on_lineage_released = on_lineage_released or (lambda task_id: None)
        self._lineage_pinning = lineage_pinning_enabled

    # -- creation (AddOwnedObject, reference_count.h:183) -------------------

    def add_owned_object(
        self, object_id: ObjectID, owner_task: TaskID | None = None
    ) -> None:
        with self._lock:
            ref = self._refs.setdefault(object_id, _Ref())
            ref.is_owned = True
            ref.owner_task = owner_task
            if owner_task is not None and self._lineage_pinning:
                self._task_outputs.setdefault(owner_task, set()).add(object_id)

    # -- python handle lifecycle (AddLocalReference / RemoveLocalReference) --

    def add_local_reference(self, object_id: ObjectID) -> None:
        with self._lock:
            self._refs.setdefault(object_id, _Ref()).local_ref_count += 1

    def remove_local_reference(self, object_id: ObjectID) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return
            ref.local_ref_count = max(0, ref.local_ref_count - 1)
            actions = self._maybe_collect(object_id, ref)
        self._run_collect_actions(actions)

    # -- task arg lifecycle (Update{Submitted,Finished}TaskReferences) -------

    def update_submitted_task_references(self, arg_ids: list[ObjectID]) -> None:
        with self._lock:
            for oid in arg_ids:
                self._refs.setdefault(oid, _Ref()).submitted_count += 1

    def update_finished_task_references(self, arg_ids: list[ObjectID]) -> None:
        all_actions = []
        with self._lock:
            for oid in arg_ids:
                ref = self._refs.get(oid)
                if ref is None:
                    continue
                ref.submitted_count = max(0, ref.submitted_count - 1)
                all_actions.extend(self._maybe_collect(oid, ref))
        self._run_collect_actions(all_actions)

    # -- borrowing -----------------------------------------------------------
    # Serializing a ref inside task args/returns makes the receiver a borrower
    # (AddBorrowedObject, reference_count.h:39). With a shared counter a borrow
    # is just another local reference taken at deserialize time; the serialize
    # side holds a temporary reference so the object can't be collected while
    # the ref is in flight.

    def add_borrowed_reference(self, object_id: ObjectID) -> None:
        self.add_local_reference(object_id)

    # -- lineage -------------------------------------------------------------

    def add_lineage_reference(self, task_id: TaskID) -> None:
        with self._lock:
            for oid in self._task_outputs.get(task_id, ()):
                self._refs[oid].lineage_count += 1

    def pinned(self, object_id: ObjectID) -> bool:
        """Eviction guard for the object store: referenced objects stay."""
        with self._lock:
            ref = self._refs.get(object_id)
            return ref is not None and not ref.out_of_scope

    # -- introspection -------------------------------------------------------

    def counts(self, object_id: ObjectID) -> tuple[int, int]:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return (0, 0)
            return (ref.local_ref_count, ref.submitted_count)

    def num_tracked(self) -> int:
        with self._lock:
            return len(self._refs)

    def snapshot(self) -> dict:
        """{object_id: total live references} for the state API."""
        with self._lock:
            return {
                oid: ref.local_ref_count + ref.submitted_count
                for oid, ref in self._refs.items()
            }

    # -- internals -----------------------------------------------------------

    def _maybe_collect(self, object_id: ObjectID, ref: _Ref) -> list:
        """Caller must hold the lock. Returns deferred callback actions —
        the callbacks re-enter the store (delete) and can cascade into more
        refcount calls, so they must run OUTSIDE the lock to keep the
        refcount-lock/store-lock ordering acyclic."""
        if not ref.out_of_scope:
            return []
        del self._refs[object_id]
        actions: list = []
        owner_task = ref.owner_task
        if owner_task is not None:
            outputs = self._task_outputs.get(owner_task)
            if outputs is not None:
                outputs.discard(object_id)
                if not outputs:
                    del self._task_outputs[owner_task]
                    actions.append(("lineage", owner_task))
        actions.append(("oos", object_id))
        return actions

    def _run_collect_actions(self, actions: list) -> None:
        for kind, arg in actions:
            if kind == "oos":
                self._on_out_of_scope(arg)
            else:
                self._on_lineage_released(arg)
