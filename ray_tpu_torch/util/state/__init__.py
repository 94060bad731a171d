from ray_tpu_torch.util.state.api import (
    get_task,
    list_actors,
    list_nodes,
    list_objects,
    list_placement_groups,
    list_tasks,
    summarize_actors,
    summarize_tasks,
)

__all__ = [
    "get_task",
    "list_actors",
    "list_nodes",
    "list_objects",
    "list_placement_groups",
    "list_tasks",
    "summarize_actors",
    "summarize_tasks",
]
