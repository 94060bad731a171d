"""Control-plane persistence (GCS fault tolerance), the port's copy of
ray_tpu/_private/gcs_storage.py.

The reference persists GCS tables to a pluggable backend (in-memory or Redis:
src/ray/gcs/gcs_server/gcs_table_storage.h, `gcs_storage` flag
ray_config_def.h:391) so a restarted control plane reconciles cluster state.
Here the control plane lives in the driver process, so "restart" means a NEW
runtime adopting the previous session's durable state:

  * internal KV          — restored verbatim
  * job counter          — monotonicity preserved across sessions
  * detached actors      — their creation TaskSpecs are persisted and
                           re-submitted, so `get_actor(name)` works in the
                           next session (fresh state, same name — matching
                           the reference's actor-restart semantics after a
                           supervisor loss)
  * placement groups     — re-registered under the SAME PlacementGroupID and
                           re-scheduled onto the new session's nodes

Writes are atomic (tmp + rename) and debounced by the runtime's maintenance
loop; a crash loses at most one flush interval of mutations — the same
guarantee an async Redis write gives the reference.
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Any, Optional

import cloudpickle


class GcsStorage:
    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def save(self, snapshot: dict) -> None:
        data = cloudpickle.dumps(snapshot, protocol=5)
        directory = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            fd, tmp = tempfile.mkstemp(dir=directory, prefix=".gcs_snap_")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(data)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

    def load(self) -> Optional[dict]:
        try:
            with open(self.path, "rb") as f:
                return cloudpickle.loads(f.read())
        except (FileNotFoundError, EOFError):
            return None
        except Exception:
            return None  # corrupt snapshot: start fresh rather than crash


def build_snapshot(runtime) -> dict:
    """Collect the durable control-plane tables from a live runtime.

    Locks are held only for shallow copies; the (potentially large) actor-
    spec serialization happens OUTSIDE both locks so a multi-MB constructor
    arg can't stall scheduling for the duration of a pickle."""
    controller = runtime.controller
    with controller._lock:
        kv = dict(controller._kv)
        job_counter = controller._job_counter
        pgs = [
            {
                "pg_id": record.pg_id.binary(),
                "bundles": [dict(b) for b in record.bundles],
                "strategy": record.strategy,
                "name": record.name,
            }
            for record in controller.placement_groups.values()
            if record.state.value != "REMOVED"
        ]
        live_detached = [
            (record.actor_id, record.name, record.namespace,
             record.max_restarts, record.class_name)
            for record in controller.actors.values()
            if record.detached and record.state.value != "DEAD"
        ]
    with runtime._lock:
        specs = {
            actor_id: runtime._actor_specs.get(actor_id)
            for actor_id, *_ in live_detached
        }
    detached = []
    for actor_id, name, namespace, max_restarts, class_name in live_detached:
        spec = specs.get(actor_id)
        if spec is None:
            continue
        try:
            spec_bytes = cloudpickle.dumps(spec, protocol=5)
        except Exception:
            continue  # unpicklable creation spec: not durable
        detached.append(
            {
                "spec": spec_bytes,
                "name": name,
                "namespace": namespace,
                "max_restarts": max_restarts,
                "class_name": class_name,
            }
        )
    return {
        "version": 1,
        "kv": kv,
        "job_counter": job_counter,
        "placement_groups": pgs,
        "detached_actors": detached,
    }


def restore_snapshot(runtime, snapshot: dict) -> None:
    """Reconcile a fresh runtime with a previous session's snapshot."""
    import time

    from ray_tpu_torch._private.controller import (
        ActorRecord,
        PlacementGroupID,
        PlacementGroupRecord,
    )
    from ray_tpu_torch._private.object_ref import ObjectRef
    from ray_tpu_torch._private.runtime import _TaskRecord

    # Daemons that survived the head crash re-register within their
    # reconnect window; until then restored actors/PGs must PARK as
    # infeasible rather than fail (they name resources only those nodes
    # provide).
    grace = getattr(runtime.config, "head_restart_grace_s", 60.0)
    if grace > 0:
        runtime.scheduler.infeasible_grace_until = time.monotonic() + grace
    controller = runtime.controller
    with controller._lock:
        controller._kv.update(snapshot.get("kv", {}))
        controller._job_counter = max(
            controller._job_counter, snapshot.get("job_counter", 0)
        )
    for pg in snapshot.get("placement_groups", ()):
        record = PlacementGroupRecord(
            pg_id=PlacementGroupID(pg["pg_id"]),
            bundles=pg["bundles"],
            strategy=pg["strategy"],
            name=pg.get("name", ""),
        )
        with controller._lock:
            controller.placement_groups[record.pg_id] = record
        controller.try_schedule_placement_group(record)
    for actor in snapshot.get("detached_actors", ()):
        try:
            spec = cloudpickle.loads(actor["spec"])
        except Exception:
            continue  # class no longer importable in this session
        record = ActorRecord(
            actor_id=spec.actor_id,
            name=actor["name"],
            namespace=actor["namespace"],
            max_restarts=actor["max_restarts"],
            detached=True,
            class_name=actor["class_name"],
        )
        try:
            controller.register_actor(record)
        except ValueError:
            continue  # name re-taken in this session already
        runtime.refcount.add_owned_object(
            spec.return_ids[0], owner_task=spec.task_id
        )
        creation_ref = ObjectRef(spec.return_ids[0])
        with runtime._lock:
            runtime._actor_specs[spec.actor_id] = spec
            runtime._actor_buffers[spec.actor_id] = []
            runtime._task_records[spec.task_id] = _TaskRecord(spec, spec.resources)
        runtime._detached_creation_refs.append(creation_ref)
        runtime._submit_when_ready(spec, spec.resources)
