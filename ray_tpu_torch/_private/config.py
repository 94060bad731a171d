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


# Flags of the reference runtime whose features the port does not
# construct: each is accepted at its default and refused otherwise, naming
# the later slice that would port it where there is one.
_UNPORTED = {
    # The reference declares this flag and no engine of it reads it: the
    # process engine starts workers on demand, in both packages.
    "prestart_workers": (True, "worker prestart is not ported: process "
                               "workers start on demand (the reference's "
                               "engines do not read this flag either)"),
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
    # Native shared-memory store (csrc/store.cc, the reference's plasma
    # equivalent): values of at least the threshold are written into one shm
    # segment that every worker process maps, instead of crossing the socket
    # (reference: ray_config_def.h max_direct_call_object_size). It builds
    # with g++ at first use, and init() raises if it cannot.
    native_store_enabled: bool = True
    native_store_threshold: int = 512 * 1024
    # Spill primary copies to disk under memory pressure
    # (local_object_manager.h); "" = $TMPDIR/ray_tpu_torch_spill_<pid>,
    # removed at shutdown (a directory given here is left in place).
    object_spilling_enabled: bool = True
    object_spill_directory: str = ""
    # Active worker-process health probing (ping/pong over the wire): a
    # worker that fails to pong within period*threshold is declared hung and
    # killed, driving the normal crash/restart path (reference:
    # gcs_health_check_manager.h:39, flags ray_config_def.h:784-790).
    # Default deadline = 3s * 10 = 30s of silence: generous enough that a
    # long interpreter-lock-holding native call (giant pickle, an nvcc
    # build's wait) is not misdiagnosed as a hang.
    health_check_period_s: float = 3.0
    health_check_failure_threshold: int = 10
    # Host-memory monitor (reference: common/memory_monitor.h:52 + the
    # retriable-FIFO worker-killing policy): above the usage threshold,
    # dispatch is backpressured and one process-backed worker is killed per
    # tick with an OOM error (its task retries). 0 disables. It runs only
    # under isolation="process": threads cannot be killed.
    memory_usage_threshold: float = 0.95
    memory_monitor_refresh_s: float = 1.0
    # Minimum gap between OOM kills: after sacrificing a worker the monitor
    # waits this many refresh periods for the reclaimed memory to show up in
    # /proc before picking another victim.
    memory_monitor_kill_cooldown_ticks: int = 5
    # Worker isolation: "thread" (in-process engine, fast) or "process"
    # (real OS worker processes with serialization + fate-sharing — the
    # reference's execution model; env override RAY_TPU_TORCH_ISOLATION).
    isolation: str = "thread"
    # CUDA devices of process-isolated workers: "" inherits the driver's
    # (a CUDA device takes contexts from many processes, so a GPU actor owns
    # its own); "cpu" hides them (CUDA_VISIBLE_DEVICES=""). The reference
    # forces its workers onto the CPU instead, because its TPU chip admits
    # one process (worker_jax_platform; ROADMAP.md §D22).
    worker_device: str = ""
    # Control-plane persistence: when set, KV/job-counter/detached-actor/PG
    # tables are snapshotted here and restored by the next session
    # (reference: gcs_table_storage.h + the Redis `gcs_storage` backend).
    gcs_storage_path: str = ""
    # After restoring a snapshot, infeasible restored actors/PGs PARK this
    # many seconds (daemons re-registering after a head restart) before the
    # scheduler reverts to failing them fast.
    head_restart_grace_s: float = 60.0
    # Worker pool: an idle task worker is killed after this long
    idle_worker_killing_time_s: float = 60.0
    # Logging: worker stdout/stderr reprinted on the driver with a prefix
    log_to_driver: bool = True
    # Web dashboard (dashboard/head.py): started by init() when enabled;
    # port 0 takes a free port (`Runtime.dashboard.url` names it).
    include_dashboard: bool = False
    dashboard_host: str = "127.0.0.1"
    dashboard_port: int = 8265

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
