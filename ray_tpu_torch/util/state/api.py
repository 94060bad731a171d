"""State API — `ray list tasks/actors/objects/nodes/...` equivalents.

Reference: python/ray/util/state/api.py + dashboard/state_aggregator.py:141
(StateAPIManager merging GCS tables with per-worker task events). Rows are
plain dicts sorted newest-first, matching the reference's column set closely
enough that `ray list`-style tooling ports over.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.runtime import get_runtime


def list_tasks(
    filters: Optional[list] = None, limit: int = 1000, detail: bool = False
) -> List[Dict[str, Any]]:
    rt = get_runtime()
    rows = []
    for ev in rt.task_events.list_events():
        row = {
            "task_id": ev.task_id.hex(),
            "name": ev.name,
            "state": ev.state,
            "type": ev.kind,
            "job_id": ev.job_id.hex() if ev.job_id else "",
            "actor_id": ev.actor_id.hex() if ev.actor_id is not None else None,
            "node_id": ev.node_id.hex() if ev.node_id is not None else None,
            "error_type": ev.error_type,
            "required_resources": dict(ev.required_resources),
        }
        if detail:
            row["state_times"] = dict(ev.state_times)
            row["error_message"] = ev.error_message
        rows.append(row)
    rows = _apply_filters(rows, filters)
    return rows[-limit:][::-1]


def get_task(task_id: str) -> Optional[Dict[str, Any]]:
    for row in list_tasks(detail=True, limit=100_000):
        if row["task_id"] == task_id:
            return row
    return None


def list_actors(filters: Optional[list] = None, limit: int = 1000) -> List[dict]:
    rt = get_runtime()
    rows = []
    for record in rt.controller.list_actors():
        rows.append(
            {
                "actor_id": record.actor_id.hex(),
                "class_name": record.class_name,
                "state": record.state.value,
                "name": record.name or "",
                "node_id": record.node_id.hex() if record.node_id else None,
                "pid": 0,
                "num_restarts": record.num_restarts,
                "death_cause": getattr(record, "death_cause", "") or "",
            }
        )
    return _apply_filters(rows, filters)[-limit:][::-1]


def list_nodes(limit: int = 1000) -> List[dict]:
    """Alive nodes, then the nodes that left, DEAD (the reference lists
    only the live table; ROADMAP.md §D31)."""
    rt = get_runtime()
    rows = []
    with rt.controller._lock:
        nodes = list(rt.controller.nodes.values()) + list(rt.controller.dead_nodes.values())
    for node in nodes:
        rows.append(
            {
                "node_id": node.node_id.hex(),
                "state": "ALIVE" if node.alive else "DEAD",
                "resources_total": dict(node.total),
                "resources_available": dict(node.available),
                "labels": dict(node.labels),
                "is_head_node": node.node_id == getattr(rt.controller, "head_node_id", None),
            }
        )
    return rows[:limit]


def list_objects(limit: int = 1000) -> List[dict]:
    rt = get_runtime()
    rows = []
    for oid, count in rt.refcount.snapshot().items():
        rows.append(
            {
                "object_id": oid.hex(),
                "reference_count": count,
                "task_id": oid.task_id.hex(),
                "in_store": rt.store.contains(oid),
            }
        )
    return rows[:limit]


def list_placement_groups(limit: int = 1000) -> List[dict]:
    rt = get_runtime()
    rows = []
    for record in rt.controller.placement_groups.values():
        rows.append(
            {
                "placement_group_id": record.pg_id.hex(),
                "name": record.name,
                "state": record.state.value,
                "strategy": record.strategy,
                "bundles": [dict(b) for b in record.bundles],
            }
        )
    return rows[:limit]


def summarize_tasks() -> Dict[str, int]:
    """State counts by task name+state (reference: `ray summary tasks`)."""
    out: Dict[str, int] = {}
    for row in list_tasks(limit=100_000):
        key = f"{row['name']}:{row['state']}"
        out[key] = out.get(key, 0) + 1
    return out


def summarize_actors() -> Dict[str, int]:
    """State counts by actor class+state (reference: `ray summary actors`,
    the summarize_tasks mirror over the actor table)."""
    out: Dict[str, int] = {}
    for row in list_actors(limit=100_000):
        key = f"{row['class_name']}:{row['state']}"
        out[key] = out.get(key, 0) + 1
    return out


def _apply_filters(rows: List[dict], filters: Optional[list]) -> List[dict]:
    """filters = [(key, "=", value) | (key, "!=", value), ...]"""
    if not filters:
        return rows
    for key, op, value in filters:
        if op == "=":
            rows = [r for r in rows if str(r.get(key)) == str(value)]
        elif op == "!=":
            rows = [r for r in rows if str(r.get(key)) != str(value)]
        else:
            raise ValueError(f"Unsupported filter op {op!r}")
    return rows
