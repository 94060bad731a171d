from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    get_current_placement_group,
    placement_group,
    remove_placement_group,
)
from ray_tpu_torch.util.check_serialize import inspect_serializability
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

__all__ = [
    "NodeAffinitySchedulingStrategy",
    "PlacementGroup",
    "PlacementGroupSchedulingStrategy",
    "get_current_placement_group",
    "inspect_serializability",
    "placement_group",
    "remove_placement_group",
    "tracing",
]
