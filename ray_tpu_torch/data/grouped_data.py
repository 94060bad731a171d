"""GroupedData: the result of Dataset.groupby.

Reference: python/ray/data/grouped_data.py — groupby produces a handle whose
aggregate() runs a distributed hash-shuffle aggregation: each input block is
partially aggregated per key (map side), partials are hash-partitioned and
merged (reduce side), finalized into one row per group. map_groups() ships
whole groups to a UDF.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import ray_tpu_torch
from ray_tpu_torch.data.aggregate import (
    AggregateFn,
    Count,
    Max,
    Mean,
    Min,
    Std,
    Sum,
)
from ray_tpu_torch.data.block import BlockAccessor, DelegatingBlockBuilder


def _group_key_fn(key):
    if key is None:
        return lambda row: None
    if callable(key):
        return key
    return lambda row: row[key]


def _partial_agg_task(block, key, aggs: List[AggregateFn], n_parts: int):
    """Map side: per-key partial accumulators, hash-partitioned.

    Returns the bare partition (not a 1-list) when n_parts == 1: with
    num_returns=1 the runtime seals the whole return value into one ref.
    """
    kf = _group_key_fn(key)
    partials: dict = {}
    for row in BlockAccessor.for_block(block).iter_rows():
        k = kf(row)
        acc = partials.get(k)
        if acc is None:
            acc = [agg.init(k) for agg in aggs]
            partials[k] = acc
        for i, agg in enumerate(aggs):
            acc[i] = agg.accumulate_row(acc[i], row)
    parts: List[dict] = [{} for _ in range(n_parts)]
    for k, acc in partials.items():
        parts[hash(k) % n_parts][k] = acc
    return parts if n_parts > 1 else parts[0]


def _merge_agg_task(key, aggs: List[AggregateFn], *partials):
    """Reduce side: merge partials for one hash partition, finalize."""
    merged: dict = {}
    for part in partials:
        for k, acc in part.items():
            if k not in merged:
                merged[k] = list(acc)
            else:
                cur = merged[k]
                for i, agg in enumerate(aggs):
                    cur[i] = agg.merge(cur[i], acc[i])
    rows = []
    for k in sorted(merged, key=lambda x: (x is None, x)):
        row = {} if key is None else {(key if isinstance(key, str) else "key"): k}
        for agg, acc in zip(aggs, merged[k]):
            row[agg.name] = agg.finalize(acc)
        rows.append(row)
    return rows, BlockAccessor.for_block(rows).metadata()


def _group_rows_task(block, key, n_parts: int):
    kf = _group_key_fn(key)
    parts: List[dict] = [{} for _ in range(n_parts)]
    for row in BlockAccessor.for_block(block).iter_rows():
        k = kf(row)
        parts[hash(k) % n_parts].setdefault(k, []).append(row)
    return parts if n_parts > 1 else parts[0]


def _map_groups_task(key, fn, batch_format, *partials):
    from ray_tpu_torch.data.block import batch_to_format

    merged: dict = {}
    for part in partials:
        for k, rows in part.items():
            merged.setdefault(k, []).extend(rows)
    builder = DelegatingBlockBuilder()
    for k in sorted(merged, key=lambda x: (x is None, x)):
        group = batch_to_format(merged[k], batch_format)
        out = fn(group)
        if isinstance(out, dict):
            # Allow scalar-valued dicts (one summary row per group) and
            # list-valued columns: normalize to ndarray columns.
            import numpy as np

            out = {
                col: np.asarray(
                    v if hasattr(v, "__len__") and not isinstance(v, str) else [v]
                )
                for col, v in out.items()
            }
        builder.add_batch(out)
    block = builder.build()
    return block, BlockAccessor.for_block(block).metadata()


class GroupedData:
    def __init__(self, dataset, key):
        self._dataset = dataset
        self._key = key

    def __repr__(self):
        return f"GroupedData(dataset={self._dataset!r}, key={self._key!r})"

    def aggregate(self, *aggs: AggregateFn):
        """Distributed hash aggregation → new Dataset of one row per group."""
        from ray_tpu_torch.data.dataset import Dataset, _dataset_from_bundles

        bundles = self._dataset._materialize_bundles()
        n_parts = max(1, len(bundles))
        partial = ray_tpu_torch.remote(_partial_agg_task)
        merge = ray_tpu_torch.remote(_merge_agg_task).options(num_returns=2)
        parts = [
            partial.options(num_returns=n_parts).remote(
                ref, self._key, list(aggs), n_parts
            )
            for ref, _ in bundles
        ]
        # Submit every merge task before blocking on any metadata so the
        # reduce side runs in parallel.
        submitted = []
        for i in range(n_parts):
            shard = [p[i] if n_parts > 1 else p for p in parts]
            submitted.append(merge.remote(self._key, list(aggs), *shard))
        out = [(ref, ray_tpu_torch.get(meta_ref)) for ref, meta_ref in submitted]
        return _dataset_from_bundles(out)

    def map_groups(self, fn: Callable, *, batch_format: str = "numpy"):
        from ray_tpu_torch.data.dataset import _dataset_from_bundles

        bundles = self._dataset._materialize_bundles()
        n_parts = max(1, len(bundles))
        group = ray_tpu_torch.remote(_group_rows_task)
        apply = ray_tpu_torch.remote(_map_groups_task).options(num_returns=2)
        parts = [
            group.options(num_returns=n_parts).remote(ref, self._key, n_parts)
            for ref, _ in bundles
        ]
        submitted = []
        for i in range(n_parts):
            shard = [p[i] if n_parts > 1 else p for p in parts]
            submitted.append(apply.remote(self._key, fn, batch_format, *shard))
        out = [(ref, ray_tpu_torch.get(meta_ref)) for ref, meta_ref in submitted]
        return _dataset_from_bundles(out)

    # -- sugar ----------------------------------------------------------
    def count(self):
        return self.aggregate(Count())

    def sum(self, on: Optional[str] = None):
        return self.aggregate(Sum(on))

    def min(self, on: Optional[str] = None):
        return self.aggregate(Min(on))

    def max(self, on: Optional[str] = None):
        return self.aggregate(Max(on))

    def mean(self, on: Optional[str] = None):
        return self.aggregate(Mean(on))

    def std(self, on: Optional[str] = None, ddof: int = 1):
        return self.aggregate(Std(on, ddof))
