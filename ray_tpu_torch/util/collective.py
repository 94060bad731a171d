"""Host-level collectives over the actor API.

Re-design of `ray.util.collective` (reference: util/collective/collective.py —
init_collective_group :120, allreduce :258, barrier) WITHOUT NCCL: host-level
coordination — config broadcast, barriers, metric and small-gradient
reduction over numpy arrays — is pure actor-space logic, so it runs on the
public API exactly like the reference's GLOO path (gloo_collective_group.py)
did. Device-plane collectives over NCCL wait for the parallel layer.

Rendezvous is a named async actor per group (the analog of the reference's
NCCLUniqueID named store actor, nccl_collective_group.py:28-54).
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np

import ray_tpu_torch


@ray_tpu_torch.remote
class _CollectiveGroupActor:
    """Gathers one contribution per rank per (kind, seq), then releases all."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._pending: dict = {}  # (kind, seq) -> {"items": {rank: x}, "event": ev}

    def _slot(self, kind: str, seq: int):
        import asyncio

        key = (kind, seq)
        slot = self._pending.get(key)
        if slot is None:
            slot = {"items": {}, "event": asyncio.Event(), "result": None}
            self._pending[key] = slot
        return key, slot

    async def collect(self, kind: str, seq: int, rank: int, payload: Any, op: str):
        import asyncio

        key, slot = self._slot(kind, seq)
        slot["items"][rank] = payload
        if len(slot["items"]) == self.world_size:
            slot["result"] = self._reduce(kind, slot["items"], op)
            slot["event"].set()
        else:
            await slot["event"].wait()
        result = slot["result"]
        # Last reader cleans up.
        slot.setdefault("readers", set()).add(rank)
        if len(slot["readers"]) == self.world_size:
            self._pending.pop(key, None)
        return result

    @staticmethod
    def _reduce(kind: str, items: dict, op: str):
        if kind == "barrier":
            return None
        ordered = [items[r] for r in sorted(items)]
        if kind == "allgather":
            return ordered
        if kind == "broadcast":
            return items[0] if 0 in items else ordered[0]
        if kind == "allreduce" or kind == "reducescatter":
            arrays = [np.asarray(x) for x in ordered]
            if op == "sum":
                out = np.sum(arrays, axis=0)
            elif op == "max":
                out = np.max(arrays, axis=0)
            elif op == "min":
                out = np.min(arrays, axis=0)
            elif op == "mean":
                out = np.mean(arrays, axis=0)
            else:
                raise ValueError(f"Unknown reduce op {op!r}")
            if kind == "reducescatter":
                return np.array_split(out, len(arrays))
            return out
        raise ValueError(f"Unknown collective kind {kind!r}")


class _GroupState:
    def __init__(self, handle, world_size: int, rank: int):
        self.handle = handle
        self.world_size = world_size
        self.rank = rank
        self.seq = 0
        self.lock = threading.Lock()

    def next_seq(self) -> int:
        with self.lock:
            self.seq += 1
            return self.seq


# Group membership is per *worker*, not per module: with the threaded engine
# every worker shares this module. The registry resolution order is
#   1. the active training session (train worker runner threads — survives the
#      backend setting up the group on a different actor-pool thread), then
#   2. thread-local storage (generic task/actor usage).
# A real per-host process backend gets per-process isolation for free.
_TL = threading.local()


def _registry() -> dict[str, _GroupState]:
    from ray_tpu_torch.air.session import _get_session

    session = _get_session()
    if session is not None:
        return session.context.extras.setdefault("collective_groups", {})
    if not hasattr(_TL, "groups"):
        _TL.groups = {}
    return _TL.groups


def create_group_state(
    world_size: int, rank: int, group_name: str = "default"
) -> _GroupState:
    """Create/join the group's rendezvous actor without registering in any
    ambient store — for backends that manage membership explicitly."""
    actor_name = f"__collective_group_{group_name}"
    handle = _CollectiveGroupActor.options(
        name=actor_name, get_if_exists=True, max_concurrency=max(world_size * 2, 8)
    ).remote(world_size)
    return _GroupState(handle, world_size, rank)


def init_collective_group(
    world_size: int, rank: int, group_name: str = "default"
) -> None:
    """Join a collective group (each member calls once). Matches the reference
    signature (util/collective/collective.py:120) minus the backend arg — the
    backend is always actor-space here."""
    _registry()[group_name] = create_group_state(world_size, rank, group_name)


def destroy_collective_group(group_name: str = "default") -> None:
    state = _registry().pop(group_name, None)
    if state is not None and state.rank == 0:
        try:
            ray_tpu_torch.kill(state.handle)
        except Exception:
            pass


def _state(group_name: str) -> _GroupState:
    state = _registry().get(group_name)
    if state is None:
        raise ValueError(
            f"Collective group {group_name!r} not initialized; call "
            "init_collective_group first"
        )
    return state


def _run(kind: str, payload, op: str, group_name: str, timeout: float):
    state = _state(group_name)
    seq = state.next_seq()
    # Train-profiler hook: inside an instrumented training session the
    # whole rendezvous (serialize + wait for the slowest rank) is the
    # `collective` phase of the current report round.
    from ray_tpu_torch.train.observability import phase_or_null

    with phase_or_null("collective"):
        return ray_tpu_torch.get(
            state.handle.collect.remote(kind, seq, state.rank, payload, op),
            timeout=timeout,
        )


def allreduce(array, op: str = "sum", group_name: str = "default", timeout: float = 60.0):
    return _run("allreduce", array, op, group_name, timeout)


def allgather(value, group_name: str = "default", timeout: float = 60.0) -> list:
    return _run("allgather", value, "sum", group_name, timeout)


def reducescatter(array, op: str = "sum", group_name: str = "default", timeout: float = 60.0):
    parts = _run("reducescatter", array, op, group_name, timeout)
    return parts[_state(group_name).rank]


def broadcast(value=None, group_name: str = "default", timeout: float = 60.0):
    """Rank 0's value wins; other ranks may pass None."""
    return _run("broadcast", value, "sum", group_name, timeout)


def barrier(group_name: str = "default", timeout: float = 60.0) -> None:
    _run("barrier", None, "sum", group_name, timeout)


def get_rank(group_name: str = "default") -> int:
    return _state(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _state(group_name).world_size
