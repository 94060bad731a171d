"""Scheduling strategies (reference: python/ray/util/scheduling_strategies.py).

"DEFAULT" → hybrid policy (top-k utilization-scored, spread threshold);
"SPREAD" → round-robin over feasible nodes;
PlacementGroupSchedulingStrategy → run inside a reserved bundle;
NodeAffinitySchedulingStrategy → pin to a node (soft or hard).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

DEFAULT = "DEFAULT"
SPREAD = "SPREAD"


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: "object"  # PlacementGroup handle
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str  # NodeID hex
    soft: bool = False
