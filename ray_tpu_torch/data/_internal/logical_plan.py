"""Logical plan: lazy operator DAG.

Reference: data/_internal/logical/interfaces.py:85 LogicalPlan + operators/
(MapBatches/MapRows/Filter/FlatMap are "one-to-one" ops the planner fuses into
single tasks; Repartition/Sort/RandomShuffle/Aggregate are all-to-all barriers
— data/_internal/planner/). The optimizer here is the same rule the reference
applies most profitably: fuse adjacent one-to-one ops so each block makes one
trip through a worker.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple


class LogicalOp:
    name: str = "op"

    def is_one_to_one(self) -> bool:
        return False


@dataclass
class InputData(LogicalOp):
    """Already-materialized block refs (from_items/from_numpy/...)."""

    block_refs: List[Any]
    metadata: List[Any]
    name: str = "FromBlocks"


@dataclass
class Read(LogicalOp):
    """Lazy read: one task per ReadTask (datasource.get_read_tasks)."""

    read_tasks: List[Any]  # callables returning iterable[Block]
    input_files: List[Any] = field(default_factory=list)
    name: str = "Read"

    def is_one_to_one(self) -> bool:
        return False  # it's a source, handled specially


@dataclass
class MapBatches(LogicalOp):
    fn: Callable
    batch_size: Optional[int] = None
    batch_format: str = "numpy"
    fn_args: tuple = ()
    fn_kwargs: dict = field(default_factory=dict)
    compute: Optional[Any] = None  # None => tasks; int/tuple => actor pool
    num_cpus: float = 1.0
    name: str = "MapBatches"

    def is_one_to_one(self) -> bool:
        return True


@dataclass
class MapRows(LogicalOp):
    fn: Callable
    compute: Optional[Any] = None
    num_cpus: float = 1.0
    name: str = "Map"

    def is_one_to_one(self) -> bool:
        return True


@dataclass
class Filter(LogicalOp):
    fn: Callable
    compute: Optional[Any] = None
    num_cpus: float = 1.0
    name: str = "Filter"

    def is_one_to_one(self) -> bool:
        return True


@dataclass
class FlatMap(LogicalOp):
    fn: Callable
    compute: Optional[Any] = None
    num_cpus: float = 1.0
    name: str = "FlatMap"

    def is_one_to_one(self) -> bool:
        return True


@dataclass
class Limit(LogicalOp):
    limit: int
    name: str = "Limit"


@dataclass
class Repartition(LogicalOp):
    num_blocks: int
    shuffle: bool = False
    name: str = "Repartition"


@dataclass
class RandomShuffle(LogicalOp):
    seed: Optional[int] = None
    name: str = "RandomShuffle"


@dataclass
class RandomizeBlockOrder(LogicalOp):
    """Cheap shuffle: permute block order only; lazy so each epoch (plan
    re-execution) draws a fresh permutation when seed is None."""

    seed: Optional[int] = None
    name: str = "RandomizeBlockOrder"


@dataclass
class Sort(LogicalOp):
    key: Any
    descending: bool = False
    name: str = "Sort"


@dataclass
class Aggregate(LogicalOp):
    aggs: List[Any]
    group_key: Optional[str] = None
    name: str = "Aggregate"


@dataclass
class Union(LogicalOp):
    others: List[Any]  # other Datasets' plans
    name: str = "Union"


@dataclass
class Zip(LogicalOp):
    other: Any  # other Dataset's plan
    name: str = "Zip"


class LogicalPlan:
    def __init__(self, ops: Optional[List[LogicalOp]] = None):
        self.ops: List[LogicalOp] = ops or []

    def with_op(self, op: LogicalOp) -> "LogicalPlan":
        return LogicalPlan(self.ops + [op])

    def describe(self) -> str:
        return " -> ".join(op.name for op in self.ops)
