"""Parallel iterators — sharded lazy iteration over actors.

Reference: python/ray/util/iter.py (from_items/from_range/from_iterators →
ParallelIterator over per-shard actors; for_each/filter/batch/flatten
transforms compose lazily; gather_sync/gather_async consume). The modern
data library supersedes this for tables; the iterator surface survives
because RL and streaming pipelines still want plain-object shards.
"""

from __future__ import annotations

import builtins
from typing import Any, Callable, Iterable, Iterator, List, Optional

import ray_tpu_torch


@ray_tpu_torch.remote
class _ShardActor:
    """Hosts one shard: a source iterator + the composed transform chain."""

    def __init__(self, source_builder: Callable[[], Iterable], transforms: list):
        def build():
            it = iter(source_builder())
            for kind, arg in transforms:
                it = _apply_transform(it, kind, arg)
            return it

        self._it = build()

    def next_batch(self, n: int) -> tuple:
        """Up to n items + done flag."""
        out = []
        done = False
        for _ in range(n):
            try:
                out.append(next(self._it))
            except StopIteration:
                done = True
                break
        return out, done


def _apply_transform(it: Iterator, kind: str, arg) -> Iterator:
    if kind == "for_each":
        return (arg(x) for x in it)
    if kind == "filter":
        return (x for x in it if arg(x))
    if kind == "flatten":
        return (y for x in it for y in x)
    if kind == "batch":
        def batches():
            buf = []
            for x in it:
                buf.append(x)
                if len(buf) == arg:
                    yield buf
                    buf = []
            if buf:
                yield buf

        return batches()
    raise ValueError(f"Unknown transform {kind!r}")


class LocalIterator:
    """Driver-side iterator over gathered shard output."""

    def __init__(self, gen: Iterator):
        self._gen = gen

    def __iter__(self):
        return self._gen

    def __next__(self):
        return next(self._gen)

    def take(self, n: int) -> List[Any]:
        return list(builtins.map(lambda pair: pair[1], zip(range(n), self._gen)))


class ParallelIterator:
    """Lazy sharded iterator; transforms run inside shard actors."""

    def __init__(self, source_builders: List[Callable], transforms: Optional[list] = None):
        self._sources = source_builders
        self._transforms = list(transforms or [])

    @property
    def num_shards(self) -> int:
        return len(self._sources)

    # -- transforms (lazy) -------------------------------------------------

    def _with(self, kind: str, arg) -> "ParallelIterator":
        return ParallelIterator(self._sources, self._transforms + [(kind, arg)])

    def for_each(self, fn: Callable) -> "ParallelIterator":
        return self._with("for_each", fn)

    def filter(self, fn: Callable) -> "ParallelIterator":
        return self._with("filter", fn)

    def flatten(self) -> "ParallelIterator":
        return self._with("flatten", None)

    def batch(self, n: int) -> "ParallelIterator":
        return self._with("batch", n)

    # -- consumption -------------------------------------------------------

    def _make_actors(self) -> list:
        return [
            _ShardActor.options(num_cpus=0).remote(src, self._transforms)
            for src in self._sources
        ]

    @staticmethod
    def _kill_all(actors) -> None:
        for actor in actors:
            try:
                ray_tpu_torch.kill(actor)
            except Exception:
                pass

    def gather_sync(self, batch_ahead: int = 16) -> LocalIterator:
        """Round-robin over shards, preserving per-shard order. Every shard
        keeps one next_batch in flight, so shards compute concurrently while
        the driver drains them in order."""
        actors = self._make_actors()

        def gen():
            try:
                pending = [
                    (actor, actor.next_batch.remote(batch_ahead))
                    for actor in actors
                ]
                while pending:
                    next_pending = []
                    for actor, ref in pending:
                        items, done = ray_tpu_torch.get(ref, timeout=300.0)
                        if not done:
                            # Re-submit BEFORE yielding: the shard works
                            # while the consumer processes this batch.
                            next_pending.append(
                                (actor, actor.next_batch.remote(batch_ahead))
                            )
                        yield from items
                    pending = next_pending
            finally:
                # Runs on exhaustion, break, take(), or generator GC —
                # abandoned iteration must not leak shard actors.
                self._kill_all(actors)

        return LocalIterator(gen())

    def gather_async(self, batch_ahead: int = 16) -> LocalIterator:
        """Items in arrival order: consume whichever shard is ready first."""
        actors = self._make_actors()

        def gen():
            try:
                in_flight = {
                    actor.next_batch.remote(batch_ahead): actor
                    for actor in actors
                }
                while in_flight:
                    ready, _ = ray_tpu_torch.wait(
                        list(in_flight), num_returns=1, timeout=300.0
                    )
                    if not ready:
                        raise TimeoutError("parallel iterator shard stalled")
                    ref = ready[0]
                    actor = in_flight.pop(ref)
                    items, done = ray_tpu_torch.get(ref)
                    if not done:
                        in_flight[actor.next_batch.remote(batch_ahead)] = actor
                    yield from items
            finally:
                self._kill_all(actors)

        return LocalIterator(gen())

    def take(self, n: int) -> List[Any]:
        return self.gather_sync().take(n)

    def count(self) -> int:
        return sum(1 for _ in self.gather_sync())


def from_iterators(builders: List[Callable[[], Iterable]]) -> ParallelIterator:
    """One shard per zero-arg iterable builder."""
    return ParallelIterator(list(builders))


def from_items(items: List[Any], num_shards: int = 2) -> ParallelIterator:
    shards = [items[i::num_shards] for i in range(num_shards)]
    return from_iterators([lambda s=s: s for s in shards])


def from_range(n: int, num_shards: int = 2) -> ParallelIterator:
    bounds = [
        (i * n // num_shards, (i + 1) * n // num_shards)
        for i in range(num_shards)
    ]
    return from_iterators([lambda b=b: range(b[0], b[1]) for b in bounds])
