"""Unified task/actor option schema + validation.

Mirrors the reference's `_private/ray_option_utils.py` (max_retries :149,
retry_exceptions :168, max_restarts/max_task_retries :193-194): one table of
options shared by `@remote(...)` and `.options(...)`, validated once.

`num_gpus` maps to the `GPU` resource, which `init()` sizes from the visible
CUDA devices.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

DEFAULT_MAX_RETRIES = 3


@dataclass
class CommonOptions:
    num_cpus: Optional[float] = None
    num_gpus: Optional[float] = None
    resources: dict[str, float] = field(default_factory=dict)
    scheduling_strategy: Any = None  # str | PlacementGroupSchedulingStrategy | ...
    name: Optional[str] = None
    runtime_env: Optional[dict] = None
    max_concurrency: int = 1


@dataclass
class TaskOptions(CommonOptions):
    num_returns: int = 1
    max_retries: int = DEFAULT_MAX_RETRIES
    retry_exceptions: bool | list[type] = False


@dataclass
class ActorOptions(CommonOptions):
    max_restarts: int = 0
    max_task_retries: int = 0
    lifetime: Optional[str] = None  # None | "detached"
    get_if_exists: bool = False
    namespace: Optional[str] = None
    # Per-actor isolation override: "process" forces a dedicated OS worker
    # process even when the runtime runs the threaded engine (a GPU actor
    # that must own its CUDA context, and give its card memory back when
    # its process dies).
    isolation: Optional[str] = None  # None | "process"


_TASK_KEYS = {f for f in TaskOptions.__dataclass_fields__}
_ACTOR_KEYS = {f for f in ActorOptions.__dataclass_fields__}


def validate_task_options(opts: dict[str, Any]) -> dict[str, Any]:
    return _validate(opts, _TASK_KEYS, kind="task")


def validate_actor_options(opts: dict[str, Any]) -> dict[str, Any]:
    return _validate(opts, _ACTOR_KEYS, kind="actor")


def _validate(opts: dict[str, Any], valid: set, kind: str) -> dict[str, Any]:
    for key, value in opts.items():
        if key not in valid:
            raise ValueError(f"Invalid option for {kind}: {key!r}")
        if key in ("num_cpus", "num_gpus") and value is not None:
            if value < 0:
                raise ValueError(f"{key} must be >= 0, got {value}")
        if key == "num_returns" and value != "streaming" and (
            not isinstance(value, int) or value < 0
        ):
            raise ValueError(
                "num_returns must be a non-negative int or 'streaming', "
                f"got {value}"
            )
        if key in ("max_retries", "max_restarts") and value < -1:
            raise ValueError(f"{key} must be >= -1, got {value}")
        if key == "resources" and value:
            for rname, amount in value.items():
                if rname in ("CPU", "GPU"):
                    raise ValueError(
                        f"Use num_{rname.lower()}s instead of resources[{rname!r}]"
                    )
                if amount < 0:
                    raise ValueError(f"resources[{rname!r}] must be >= 0")
    return opts


def to_resource_request(
    num_cpus: Optional[float],
    num_gpus: Optional[float],
    resources: Optional[dict[str, float]],
    default_num_cpus: float,
) -> dict[str, float]:
    """Collapse the option fields into a single resource-name → amount map."""
    request: dict[str, float] = {}
    cpus = default_num_cpus if num_cpus is None else num_cpus
    if cpus:
        request["CPU"] = float(cpus)
    if num_gpus:
        request["GPU"] = float(num_gpus)
    for name, amount in (resources or {}).items():
        if amount:
            request[name] = float(amount)
    return request
