"""Placement groups (reference: python/ray/util/placement_group.py —
placement_group() :139, PlacementGroup :34, get_current_placement_group :297)."""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch._private.controller import PlacementGroupState
from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch.exceptions import GetTimeoutError


def get_runtime():
    from ray_tpu_torch._private.runtime import get_runtime as _get

    return _get()

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID):
        self.id = pg_id

    def ready(self, timeout: Optional[float] = None) -> bool:
        """Block until all bundles are committed (2PC done)."""
        record = get_runtime().controller.get_placement_group(self.id)
        if record is None:
            raise ValueError(f"Unknown placement group {self.id}")
        if not record.ready_event.wait(timeout):
            raise GetTimeoutError(f"Placement group {self.id} not ready in {timeout}s")
        return record.state == PlacementGroupState.CREATED

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        record = get_runtime().controller.get_placement_group(self.id)
        if record is None:
            return False
        record.ready_event.wait(timeout_seconds)
        return record.state == PlacementGroupState.CREATED

    @property
    def bundle_specs(self) -> list[dict]:
        record = get_runtime().controller.get_placement_group(self.id)
        return [dict(b) for b in record.bundles] if record else []

    def bundle_node_ids(self) -> dict[int, str]:
        """Which node each bundle landed on (the worker group's node ranks)."""
        record = get_runtime().controller.get_placement_group(self.id)
        if record is None:
            return {}
        return {i: nid.hex() for i, nid in record.bundle_nodes.items()}

    def __reduce__(self):
        return (PlacementGroup, (self.id,))


def placement_group(
    bundles: list[dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"Invalid strategy {strategy!r}; one of {VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("bundles must be non-empty")
    for bundle in bundles:
        if not bundle or any(v < 0 for v in bundle.values()):
            raise ValueError(f"Invalid bundle {bundle!r}")
    record = get_runtime().controller.create_placement_group(bundles, strategy, name)
    return PlacementGroup(record.pg_id)


def remove_placement_group(pg: PlacementGroup) -> None:
    get_runtime().controller.remove_placement_group(pg.id)


def get_current_placement_group() -> Optional[PlacementGroup]:
    """The PG whose bundle the current task runs in, if any (derived from the
    synthetic group resources in the task's grant)."""
    from ray_tpu_torch._private.engine import CONTEXT

    for res in CONTEXT.resource_grant or {}:
        if "_group_" in res:
            hex_id = res.rsplit("_", 1)[-1]
            try:
                return PlacementGroup(PlacementGroupID.from_hex(hex_id))
            except ValueError:
                continue
    return None
