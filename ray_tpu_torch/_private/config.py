"""Flag system — single source of truth for runtime tunables.

Mirrors the reference's `RAY_CONFIG(type, name, default)` registry
(src/ray/common/ray_config_def.h) including env-var override: every flag can be
overridden with env `RAY_TPU_TORCH_<NAME>`, and `init(_system_config={...})` overrides
both.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields


def _env_override(name: str, default):
    raw = os.environ.get(f"RAY_TPU_TORCH_{name.upper()}")
    if raw is None:
        return default
    if isinstance(default, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


# Flags of the reference runtime whose features the in-process port does
# not construct: each is accepted at its default and refused otherwise,
# naming the later slice that would port it.
_UNPORTED = {
    "isolation": ("thread",
                  "worker processes (process_engine) are not "
                  "ported: the port's runtime runs in-process only until a slice "
                  "needs worker processes (ROADMAP.md §B10)"),
    "gcs_storage_path": ("", "GCS persistence (gcs_storage) is not ported "
                             "(ROADMAP.md §B10)"),
    "native_store_enabled": (False, "the native shared-memory store (native_store) "
                                    "is not ported (ROADMAP.md §B10)"),
    "object_spilling_enabled": (False, "object spilling (external_storage) is not "
                                       "ported (ROADMAP.md §B10)"),
    "memory_usage_threshold": (0.0, "the memory monitor watches worker processes, "
                                    "which are not ported (ROADMAP.md §B10)"),
    "include_dashboard": (False, "the dashboard is not ported (ROADMAP.md §B10)"),
}


@dataclass
class Config:
    # Scheduling (reference: hybrid policy, ray_config_def.h:193 spread threshold)
    scheduler_spread_threshold: float = 0.5
    scheduler_top_k_fraction: float = 0.2
    # Memory cap for the host object store (0 = derive from system memory; the
    # reference defaults to 30% of RAM with a 200GB cap, ray_constants.py:51-53).
    object_store_memory: int = 0
    object_store_memory_fraction: float = 0.3
    object_store_memory_cap: int = 200 * 1024**3
    # Copy (serialize/deserialize) task args even in the in-process engine so
    # mutation bugs surface in tests; direct zero-copy handoff when False.
    inproc_copy_args: bool = False
    # Store sealed objects as serialized bytes so every `get` returns a fresh
    # copy (the reference's immutability contract). False = zero-copy sharing
    # between thread-workers (fast, but mutations alias).
    serialize_objects: bool = True

    def __post_init__(self):
        for f in fields(self):
            setattr(self, f.name, _env_override(f.name, getattr(self, f.name)))

    def apply_overrides(self, overrides: dict | None):
        if not overrides:
            return self
        valid = {f.name for f in fields(self)}
        for key, value in overrides.items():
            if key in _UNPORTED:
                default, message = _UNPORTED[key]
                if value != default:
                    raise NotImplementedError(f"{key}={value!r}: {message}")
            elif key not in valid:
                raise ValueError(f"Unknown _system_config key: {key!r}")
            else:
                setattr(self, key, value)
        return self


GLOBAL_CONFIG = Config()
