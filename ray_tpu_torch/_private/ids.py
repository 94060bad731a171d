"""Deterministic nested ID scheme.

Follows the reference's design (src/ray/design_docs/id_specification.md): IDs nest
so that the submitter can compute an ObjectID *without coordination* — the property
that makes ownership-based GC work:

    JobID (4B)  ⊂  ActorID (16B)  ⊂  TaskID (24B)  ⊂  ObjectID (28B)

ObjectID = TaskID + little-endian 4-byte return/put index.  ActorID for a normal
(non-actor) task is the nil actor id.
"""

from __future__ import annotations

import os
import random
import threading

# ID uniqueness needs speed, not cryptographic strength: randbytes (Mersenne
# Twister) is ~20x faster than os.urandom and the submit path mints two IDs
# per task. A PRIVATE instance seeded from urandom — never the global random
# module, which user code re-seeds for reproducibility (random.seed(42) in
# two tasks would otherwise mint identical ID streams -> object collisions).
# Re-seeded after fork: a forked child inheriting the parent's PRNG state
# would mint the parent's exact ID stream (os.urandom had no such hazard).
_rand = random.Random(os.urandom(16))


def _randbytes(n: int) -> bytes:
    return _rand.randbytes(n)


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=lambda: _rand.seed(os.urandom(16)))

JOB_ID_SIZE = 4
ACTOR_UNIQUE_SIZE = 12  # ActorID = unique(12) + JobID(4)
ACTOR_ID_SIZE = ACTOR_UNIQUE_SIZE + JOB_ID_SIZE  # 16
TASK_UNIQUE_SIZE = 8  # TaskID = unique(8) + ActorID(16)
TASK_ID_SIZE = TASK_UNIQUE_SIZE + ACTOR_ID_SIZE  # 24
OBJECT_ID_SIZE = TASK_ID_SIZE + 4  # 28


class BaseID:
    __slots__ = ("_bytes", "_hash")
    SIZE = 0

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, got {len(id_bytes)}"
            )
        self._bytes = id_bytes
        # IDs key every hot-path dict (store entries, refcounts, task
        # records); caching the hash shaves ~25 rehashes per task.
        self._hash = hash((type(self).__name__, id_bytes))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def from_random(cls):
        return cls(_randbytes(cls.SIZE))

    @classmethod
    def nil(cls):
        return cls(b"\xff" * cls.SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\xff" * self.SIZE

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __hash__(self):
        return self._hash

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = JOB_ID_SIZE

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(value.to_bytes(JOB_ID_SIZE, "little"))

    def to_int(self) -> int:
        return int.from_bytes(self._bytes, "little")


class ActorID(BaseID):
    SIZE = ACTOR_ID_SIZE

    @classmethod
    def of(cls, job_id: JobID, unique: bytes | None = None) -> "ActorID":
        unique = unique if unique is not None else _randbytes(ACTOR_UNIQUE_SIZE)
        return cls(unique + job_id.binary())

    @property
    def job_id(self) -> JobID:
        return JobID(self._bytes[ACTOR_UNIQUE_SIZE:])


class TaskID(BaseID):
    SIZE = TASK_ID_SIZE

    @classmethod
    def of(cls, actor_id: ActorID, unique: bytes | None = None) -> "TaskID":
        unique = unique if unique is not None else _randbytes(TASK_UNIQUE_SIZE)
        return cls(unique + actor_id.binary())

    @classmethod
    def for_job(cls, job_id: JobID) -> "TaskID":
        return cls.of(ActorID.of(job_id))

    @property
    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[TASK_UNIQUE_SIZE:])

    @property
    def job_id(self) -> JobID:
        return self.actor_id.job_id


class ObjectID(BaseID):
    SIZE = OBJECT_ID_SIZE

    @classmethod
    def of(cls, task_id: TaskID, index: int) -> "ObjectID":
        """index: 1-based return index (put objects use a separate counter space)."""
        return cls(task_id.binary() + index.to_bytes(4, "little"))

    @property
    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:TASK_ID_SIZE])

    @property
    def index(self) -> int:
        return int.from_bytes(self._bytes[TASK_ID_SIZE:], "little")


class NodeID(BaseID):
    SIZE = 16


class WorkerID(BaseID):
    SIZE = 16


class PlacementGroupID(BaseID):
    SIZE = 16


class _Counter:
    """Thread-safe monotonically increasing counter."""

    def __init__(self, start: int = 0):
        self._value = start
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value
