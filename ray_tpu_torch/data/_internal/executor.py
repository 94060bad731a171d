"""Streaming executor.

Reference: data/_internal/execution/streaming_executor.py:48,173 — a pull-based
pipeline: each operator stage holds a bounded set of in-flight tasks over
blocks in the object store; downstream pulls as results land, so memory stays
bounded (backpressure) and stages overlap. All-to-all ops (sort/shuffle/
repartition) are barriers that materialize their input, like the reference's
AllToAllOperator.

Fusion: consecutive one-to-one ops become ONE task per block
(logical/rules/operator_fusion.py equivalent) — each block makes a single
worker round-trip.
"""

from __future__ import annotations

import random as _random
import time
from collections import deque
from typing import Any, Callable, Iterator, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (
    BlockAccessor,
    BlockMetadata,
    DelegatingBlockBuilder,
    batch_to_format,
)
from ray_tpu_torch.data._internal.logical_plan import (
    Aggregate,
    Filter,
    FlatMap,
    InputData,
    Limit,
    LogicalPlan,
    MapBatches,
    MapRows,
    RandomShuffle,
    RandomizeBlockOrder,
    Read,
    Repartition,
    Sort,
    Union,
    Zip,
)

# Bounded in-flight tasks per map stage (the streaming budget; reference
# gates on resource budgets in streaming_executor_state.py).
DEFAULT_MAX_IN_FLIGHT = 8

RefBundle = Tuple[Any, BlockMetadata]  # (block_ref, metadata)


# -- fused map transform ------------------------------------------------------


def _apply_one_to_one(ops: List[Any], block: Any) -> Any:
    """Run a fused chain of one-to-one ops over one block, returning a block."""
    for op in ops:
        acc = BlockAccessor.for_block(block)
        if isinstance(op, MapBatches):
            out = DelegatingBlockBuilder()
            n = acc.num_rows()
            size = op.batch_size or max(1, n)
            for start in range(0, n, size):
                piece = acc.slice(start, min(n, start + size))
                batch = batch_to_format(piece, op.batch_format)
                result = op.fn(batch, *op.fn_args, **op.fn_kwargs)
                out.add_batch(result)
            block = out.build()
        elif isinstance(op, MapRows):
            out = DelegatingBlockBuilder()
            for row in acc.iter_rows():
                out.add(op.fn(row))
            block = out.build()
        elif isinstance(op, Filter):
            out = DelegatingBlockBuilder()
            for row in acc.iter_rows():
                if op.fn(row):
                    out.add(row)
            block = out.build()
        elif isinstance(op, FlatMap):
            out = DelegatingBlockBuilder()
            for row in acc.iter_rows():
                for produced in op.fn(row):
                    out.add(produced)
            block = out.build()
        else:
            raise TypeError(f"Not a one-to-one op: {op}")
    return block


def _map_task(ops: List[Any], block: Any):
    t0 = time.perf_counter()
    result = _apply_one_to_one(ops, block)
    meta = BlockAccessor.for_block(result).metadata(
        exec_stats={"wall_s": time.perf_counter() - t0}
    )
    return result, meta


def _read_task(read_fn: Callable, ops: List[Any]):
    """Execute one ReadTask (+ fused downstream one-to-one ops)."""
    t0 = time.perf_counter()
    builder = DelegatingBlockBuilder()
    for block in read_fn():
        if ops:
            block = _apply_one_to_one(ops, block)
        builder.add_batch(block)
    result = builder.build()
    meta = BlockAccessor.for_block(result).metadata(
        exec_stats={"wall_s": time.perf_counter() - t0}
    )
    return result, meta


class _MapWorker:
    """Actor-pool worker for compute=actors map stages (reference:
    execution/operators/actor_pool_map_operator.py:34)."""

    def __init__(self, ops: List[Any]):
        self._ops = ops

    def map(self, block: Any):
        return _map_task(self._ops, block)


# -- stage iterators ----------------------------------------------------------


def _tracked(
    stream: Iterator[RefBundle], stats: Optional[dict], name: str
) -> Iterator[RefBundle]:
    """Wrap a stage's output stream with per-op accounting: blocks/rows/
    bytes produced, per-task execution wall times, and the stage's streaming
    wall clock (reference: data/_internal/stats.py per-operator stats — the
    main input-pipeline perf-debugging surface)."""
    if stats is None:
        yield from stream
        return
    s = stats.setdefault(
        name,
        {"blocks": 0, "rows": 0, "bytes": 0, "task_wall_s": [], "wall_s": 0.0},
    )
    t0 = time.perf_counter()
    for ref, meta in stream:
        s["blocks"] += 1
        if meta.num_rows is not None:
            s["rows"] += meta.num_rows
        if meta.size_bytes is not None:
            s["bytes"] += meta.size_bytes
        wall = (meta.exec_stats or {}).get("wall_s")
        if wall is not None:
            s["task_wall_s"].append(wall)
        s["wall_s"] = time.perf_counter() - t0
        yield ref, meta
    s["wall_s"] = time.perf_counter() - t0


def dominant_stage(stats: dict) -> Optional[Tuple[str, float]]:
    """(stage name, seconds) of the stage with the largest measured
    execution time — task execution wall when the stage reported it, the
    streaming wall clock otherwise. This is what the train profiler blames
    a worker's `data_wait` phase on."""
    best: Optional[Tuple[str, float]] = None
    for stage, s in list(stats.items()):
        try:
            seconds = sum(s.get("task_wall_s") or ()) or s.get("wall_s", 0.0)
        except Exception:
            continue
        if seconds and (best is None or seconds > best[1]):
            best = (stage, seconds)
    return best


def _iter_map_stage(
    upstream: Iterator[RefBundle],
    ops: List[Any],
) -> Iterator[RefBundle]:
    """Bounded-in-flight, order-preserving task pipeline over blocks."""
    compute = next((op.compute for op in ops if op.compute is not None), None)
    num_cpus = max((op.num_cpus for op in ops), default=1.0)
    name = "+".join(op.name for op in ops)

    if compute is not None:
        yield from _iter_actor_pool_stage(upstream, ops, compute, num_cpus)
        return

    remote_map = ray_tpu_torch.remote(_map_task).options(
        num_returns=2, num_cpus=num_cpus, name=name
    )
    pending: deque = deque()
    upstream = iter(upstream)
    exhausted = False
    while True:
        while not exhausted and len(pending) < DEFAULT_MAX_IN_FLIGHT:
            try:
                block_ref, _ = next(upstream)
            except StopIteration:
                exhausted = True
                break
            pending.append(remote_map.remote(ops, block_ref))
        if not pending:
            break
        block_ref, meta_ref = pending.popleft()
        meta = ray_tpu_torch.get(meta_ref)
        yield block_ref, meta


def _iter_actor_pool_stage(
    upstream: Iterator[RefBundle],
    ops: List[Any],
    compute: Any,
    num_cpus: float,
) -> Iterator[RefBundle]:
    if isinstance(compute, tuple):
        pool_size = compute[1]
    else:
        pool_size = int(compute)
    worker_cls = ray_tpu_torch.remote(_MapWorker).options(num_cpus=num_cpus)
    workers = [worker_cls.remote(ops) for _ in range(pool_size)]
    pending: deque = deque()
    upstream = iter(upstream)
    exhausted = False
    i = 0
    try:
        while True:
            while not exhausted and len(pending) < 2 * pool_size:
                try:
                    block_ref, _ = next(upstream)
                except StopIteration:
                    exhausted = True
                    break
                worker = workers[i % pool_size]
                i += 1
                pending.append(
                    worker.map.options(num_returns=2).remote(block_ref)
                )
            if not pending:
                break
            block_ref, meta_ref = pending.popleft()
            yield block_ref, ray_tpu_torch.get(meta_ref)
    finally:
        for w in workers:
            ray_tpu_torch.kill(w)


def _iter_read_stage(
    read_tasks: List[Callable], fused_ops: List[Any]
) -> Iterator[RefBundle]:
    remote_read = ray_tpu_torch.remote(_read_task).options(num_returns=2, name="Read")
    pending: deque = deque()
    tasks = iter(read_tasks)
    exhausted = False
    while True:
        while not exhausted and len(pending) < DEFAULT_MAX_IN_FLIGHT:
            try:
                rt = next(tasks)
            except StopIteration:
                exhausted = True
                break
            pending.append(remote_read.remote(rt, fused_ops))
        if not pending:
            break
        block_ref, meta_ref = pending.popleft()
        yield block_ref, ray_tpu_torch.get(meta_ref)


def _iter_limit_stage(
    upstream: Iterator[RefBundle], limit: int
) -> Iterator[RefBundle]:
    taken = 0
    for block_ref, meta in upstream:
        if taken >= limit:
            return
        n = meta.num_rows
        if n is None:
            n = BlockAccessor.for_block(ray_tpu_torch.get(block_ref)).num_rows()
        if taken + n <= limit:
            taken += n
            yield block_ref, meta
        else:
            want = limit - taken
            block = ray_tpu_torch.get(block_ref)
            piece = BlockAccessor.for_block(block).slice(0, want)
            acc = BlockAccessor.for_block(piece)
            yield ray_tpu_torch.put(piece), acc.metadata()
            taken = limit
            return


# -- all-to-all stages (barriers) --------------------------------------------


def _materialize(upstream: Iterator[RefBundle]) -> List[RefBundle]:
    return list(upstream)


def _resolve_bundles(outs: List[Tuple[Any, Any]]) -> Iterator[RefBundle]:
    """Resolve (block_ref, meta_ref) pairs with ONE batched get — per-block
    gets would serialize a round trip per output block."""
    metas = ray_tpu_torch.get([meta_ref for _, meta_ref in outs])
    yield from zip([ref for ref, _ in outs], metas)


def _split_block_task(block: Any, n: int):
    """Split one block into n near-equal slices (repartition fan-out).

    Returns the bare slice when n == 1: with num_returns=1 the runtime seals
    the whole return value into one ref, so a 1-list would nest.
    """
    acc = BlockAccessor.for_block(block)
    rows = acc.num_rows()
    out = []
    for i in range(n):
        start = (rows * i) // n
        end = (rows * (i + 1)) // n
        out.append(acc.slice(start, end))
    return out if n > 1 else out[0]


def _concat_blocks_task(*blocks):
    builder = DelegatingBlockBuilder()
    for b in blocks:
        builder.add_batch(b)
    result = builder.build()
    return result, BlockAccessor.for_block(result).metadata()


def _repartition(bundles: List[RefBundle], n: int) -> Iterator[RefBundle]:
    """Minimal-movement repartition: split every block into n parts, then
    concat part i of every block into output block i (push-based shuffle
    skeleton, reference: push_based_shuffle.py)."""
    split = ray_tpu_torch.remote(_split_block_task)
    concat = ray_tpu_torch.remote(_concat_blocks_task).options(num_returns=2)
    if not bundles:
        for _ in range(n):
            ref, meta_ref = concat.remote([])
            yield ref, ray_tpu_torch.get(meta_ref)
        return
    parts = [
        split.options(num_returns=n).remote(block_ref, n)
        for block_ref, _ in bundles
    ]
    # parts[j] = n refs of block j's slices.
    outs = []
    for i in range(n):
        shard_refs = [p[i] if n > 1 else p for p in parts]
        outs.append(concat.remote(*shard_refs))
    yield from _resolve_bundles(outs)


def _shuffle_block_task(block: Any, seed):
    acc = BlockAccessor.for_block(block)
    rows = list(acc.iter_rows())
    _random.Random(seed).shuffle(rows)
    builder = DelegatingBlockBuilder()
    for r in rows:
        builder.add(r)
    result = builder.build()
    return result, BlockAccessor.for_block(result).metadata()


def _random_shuffle(
    bundles: List[RefBundle], seed: Optional[int]
) -> Iterator[RefBundle]:
    """Global shuffle: repartition slices round-robin with a seeded permutation
    of slice assignment, then per-block row shuffle."""
    n = max(1, len(bundles))
    rng = _random.Random(seed)
    shuffle_one = ray_tpu_torch.remote(_shuffle_block_task).options(num_returns=2)
    repartitioned = list(_repartition(bundles, n))
    rng.shuffle(repartitioned)
    outs = [
        shuffle_one.remote(block_ref, None if seed is None else seed + i)
        for i, (block_ref, _) in enumerate(repartitioned)
    ]
    yield from _resolve_bundles(outs)


def _sort_block_task(block: Any, key, descending: bool):
    acc = BlockAccessor.for_block(block)
    rows = sorted(acc.iter_rows(), key=_key_fn(key), reverse=descending)
    builder = DelegatingBlockBuilder()
    for r in rows:
        builder.add(r)
    result = builder.build()
    return result, BlockAccessor.for_block(result).metadata()


def _key_fn(key):
    if callable(key):
        return key
    if isinstance(key, str):
        return lambda row: row[key]
    return lambda row: row


def _sample_boundaries_task(block: Any, key, n_samples: int):
    acc = BlockAccessor.for_block(block)
    rows = list(acc.iter_rows())
    if not rows:
        return []
    kf = _key_fn(key)
    step = max(1, len(rows) // max(1, n_samples))
    return sorted(kf(r) for r in rows[::step])


def _partition_block_task(block: Any, key, boundaries: list, descending: bool):
    """Range-partition one block by the sorted boundaries → len(boundaries)+1 parts."""
    import bisect

    acc = BlockAccessor.for_block(block)
    kf = _key_fn(key)
    n_parts = len(boundaries) + 1
    parts: List[list] = [[] for _ in range(n_parts)]
    for row in acc.iter_rows():
        idx = bisect.bisect_right(boundaries, kf(row))
        if descending:
            idx = n_parts - 1 - idx
        parts[idx].append(row)
    return parts


def _merge_sorted_task(key, descending, *parts):
    rows = [r for p in parts for r in p]
    rows.sort(key=_key_fn(key), reverse=descending)
    builder = DelegatingBlockBuilder()
    for r in rows:
        builder.add(r)
    result = builder.build()
    return result, BlockAccessor.for_block(result).metadata()


def _sort(
    bundles: List[RefBundle], key, descending: bool
) -> Iterator[RefBundle]:
    """Distributed sample-sort (reference: data/_internal/planner/sort.py):
    sample boundaries → range-partition each block → merge per range."""
    if not bundles:
        return
    if len(bundles) == 1:
        sort_one = ray_tpu_torch.remote(_sort_block_task).options(num_returns=2)
        ref, meta_ref = sort_one.remote(bundles[0][0], key, descending)
        yield ref, ray_tpu_torch.get(meta_ref)
        return
    n = len(bundles)
    sample = ray_tpu_torch.remote(_sample_boundaries_task)
    samples = ray_tpu_torch.get(
        [sample.remote(ref, key, 8) for ref, _ in bundles]
    )
    flat = sorted(s for block in samples for s in block)
    if not flat:
        for ref, meta in bundles:
            yield ref, meta
        return
    boundaries = [flat[(len(flat) * i) // n] for i in range(1, n)]
    partition = ray_tpu_torch.remote(_partition_block_task)
    merge = ray_tpu_torch.remote(_merge_sorted_task).options(num_returns=2)
    parts = [
        partition.options(num_returns=n).remote(ref, key, boundaries, descending)
        for ref, _ in bundles
    ]
    outs = []
    for i in range(n):
        shard = [p[i] if n > 1 else p for p in parts]
        outs.append(merge.remote(key, descending, *shard))
    yield from _resolve_bundles(outs)


def _zip_blocks_task(a: Any, b: Any):
    da = BlockAccessor.for_block(a).to_numpy_dict()
    db = BlockAccessor.for_block(b).to_numpy_dict()
    merged = dict(da)
    for k, v in db.items():
        merged[k if k not in merged else f"{k}_1"] = v
    return merged, BlockAccessor.for_block(merged).metadata()


def _align_to_boundaries(
    bundles: List[RefBundle], boundaries: List[int], row_counts: List[int]
) -> Iterator[Any]:
    """Re-slice a bundle list so output block row-counts match `boundaries`
    (the reference re-aligns zip inputs the same way). Yields block refs.
    `row_counts` carries the precomputed rows of each input bundle."""
    slice_task = ray_tpu_torch.remote(
        lambda block, s, e: BlockAccessor.for_block(block).slice(s, e)
    )
    concat = ray_tpu_torch.remote(_concat_blocks_task).options(num_returns=2)
    src = iter(zip(bundles, row_counts))
    cur_ref = None
    cur_rows = 0
    offset = 0
    for want in boundaries:
        pieces = []
        need = want
        while need > 0:
            if cur_ref is None:
                (cur_ref, _meta), cur_rows = next(src)
                offset = 0
            take = min(need, cur_rows - offset)
            if take == cur_rows and offset == 0:
                pieces.append(cur_ref)
            else:
                pieces.append(slice_task.remote(cur_ref, offset, offset + take))
            offset += take
            need -= take
            if offset >= cur_rows:
                cur_ref = None
        if len(pieces) == 1:
            yield pieces[0]
        else:
            ref, _meta_ref = concat.remote(*pieces)
            yield ref


# -- plan compilation ---------------------------------------------------------


def execute_streaming(
    plan: LogicalPlan, stats: Optional[dict] = None
) -> Iterator[RefBundle]:
    """Compile the logical plan into chained stage iterators and stream."""
    stream: Optional[Iterator[RefBundle]] = None
    ops = list(plan.ops)
    if stats is not None:
        # stats reflect the LATEST execution (re-iterating a Dataset re-runs
        # the plan; mixing epochs would fabricate counts).
        stats.clear()

    def _stage_key(base: str) -> str:
        if stats is None or base not in stats:
            return base
        k = 2
        while f"{base} ({k})" in stats:
            k += 1
        return f"{base} ({k})"

    i = 0
    while i < len(ops):
        op = ops[i]
        if isinstance(op, InputData):
            stream = iter(list(zip(op.block_refs, op.metadata)))
            i += 1
        elif isinstance(op, Read):
            # Fuse trailing one-to-one ops into the read tasks.
            fused: List[Any] = []
            j = i + 1
            while j < len(ops) and ops[j].is_one_to_one() and ops[j].compute is None:
                fused.append(ops[j])
                j += 1
            stage = "Read" + ("->" + "+".join(f.name for f in fused) if fused else "")
            stream = _tracked(
                _iter_read_stage(op.read_tasks, fused), stats, _stage_key(stage)
            )
            i = j
        elif op.is_one_to_one():
            # Fuse only stages with identical compute specs — fusing actor
            # pools of different sizes would silently run the later stage
            # under the earlier stage's pool.
            fused = [op]
            j = i + 1
            while (
                j < len(ops)
                and ops[j].is_one_to_one()
                and ops[j].compute == op.compute
            ):
                fused.append(ops[j])
                j += 1
            stream = _tracked(
                _iter_map_stage(stream, fused),
                stats,
                _stage_key("+".join(f.name for f in fused)),
            )
            i = j
        elif isinstance(op, Limit):
            stream = _tracked(
                _iter_limit_stage(stream, op.limit), stats, _stage_key("Limit")
            )
            i += 1
        elif isinstance(op, Repartition):
            bundles = _materialize(stream)
            if op.shuffle:
                # Full shuffle-repartition: redistribute slices, then permute
                # rows within each output block (reference push_based_shuffle
                # with shuffle=True contract).
                shuffle_one = ray_tpu_torch.remote(_shuffle_block_task).options(
                    num_returns=2
                )

                def _shuffled(parts):
                    # seed=None → fresh permutation every plan execution
                    # (each epoch re-runs the plan and must re-shuffle).
                    outs = [shuffle_one.remote(ref, None) for ref, _ in parts]
                    yield from _resolve_bundles(outs)

                stream = _tracked(
                    _shuffled(list(_repartition(bundles, op.num_blocks))),
                    stats, _stage_key("Repartition(shuffle)"),
                )
            else:
                stream = _tracked(
                    _repartition(bundles, op.num_blocks), stats, _stage_key("Repartition")
                )
            i += 1
        elif isinstance(op, RandomShuffle):
            stream = _tracked(
                _random_shuffle(_materialize(stream), op.seed),
                stats, _stage_key("RandomShuffle"),
            )
            i += 1
        elif isinstance(op, RandomizeBlockOrder):
            import random as _random

            bundles = _materialize(stream)
            _random.Random(op.seed).shuffle(bundles)
            stream = iter(bundles)
            i += 1
        elif isinstance(op, Sort):
            stream = _tracked(
                _sort(_materialize(stream), op.key, op.descending),
                stats, _stage_key("Sort"),
            )
            i += 1
        elif isinstance(op, Union):
            def _union(base, others):
                yield from base
                for other_plan in others:
                    yield from execute_streaming(other_plan)

            stream = _union(stream, op.others)
            i += 1
        elif isinstance(op, Zip):
            zip_task = ray_tpu_torch.remote(_zip_blocks_task).options(num_returns=2)

            def _zip(base, other_plan):
                base_bundles = list(base)
                other_bundles = list(execute_streaming(other_plan))

                def _rows(bundles):
                    out = []
                    for ref, meta in bundles:
                        n = meta.num_rows
                        if n is None:
                            n = BlockAccessor.for_block(
                                ray_tpu_torch.get(ref)
                            ).num_rows()
                        out.append(n)
                    return out

                base_rows = _rows(base_bundles)
                other_rows = _rows(other_bundles)
                if sum(base_rows) != sum(other_rows):
                    raise ValueError(
                        "zip: datasets have different row counts "
                        f"({sum(base_rows)} vs {sum(other_rows)})"
                    )
                aligned = _align_to_boundaries(
                    other_bundles, base_rows, other_rows
                )
                for (ref_a, _), ref_b in zip(base_bundles, aligned):
                    ref, meta_ref = zip_task.remote(ref_a, ref_b)
                    yield ref, ray_tpu_torch.get(meta_ref)

            stream = _zip(stream, op.other)
            i += 1
        else:
            raise TypeError(f"Unknown logical op {op}")
    return stream if stream is not None else iter(())
