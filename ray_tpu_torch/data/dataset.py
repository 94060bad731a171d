"""Dataset: lazy distributed data on blocks in the object store.

Reference: python/ray/data/dataset.py (4,590 LoC) — a Dataset is a LogicalPlan
over blocks; transformations append logical ops, consumption compiles the plan
through the streaming executor (data/_internal/execution/streaming_executor.py:48)
into bounded-in-flight remote tasks over block refs. `streaming_split`
(dataset.py:1089) is the Train-feeding primitive.

Feeding notes: `iter_batches(batch_format="numpy")` yields dict-of-ndarray
batches sized exactly `batch_size` (static step shapes); `drop_last=True` is
the recommended Train default. `iter_device_batches` puts them on the card,
one batch ahead; `iter_torch_batches` gives host tensors, as the
reference's does.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data._internal.executor import RefBundle, execute_streaming
from ray_tpu_torch.data._internal.logical_plan import (
    Filter,
    FlatMap,
    InputData,
    Limit,
    LogicalPlan,
    MapBatches,
    MapRows,
    RandomShuffle,
    RandomizeBlockOrder,
    Repartition,
    Sort,
    Union as UnionOp,
    Zip,
)
from ray_tpu_torch.data.block import (
    BlockAccessor,
    BlockMetadata,
    DelegatingBlockBuilder,
    batch_to_format,
)
from ray_tpu_torch.data.iterator import DataIterator, _SplitCoordinator


def _dataset_from_bundles(bundles: List[RefBundle]) -> "MaterializedDataset":
    refs = [b[0] for b in bundles]
    metas = [b[1] for b in bundles]
    return MaterializedDataset(
        LogicalPlan([InputData(block_refs=refs, metadata=metas)]), bundles
    )


class Dataset:
    """A lazy, distributed collection of rows."""

    def __init__(self, plan: LogicalPlan):
        self._plan = plan
        self._stats: Dict[str, Any] = {}

    # ------------------------------------------------------------------
    # Transformations (lazy — append a logical op)
    # ------------------------------------------------------------------

    def _with_op(self, op) -> "Dataset":
        return Dataset(self._plan.with_op(op))

    def map(self, fn: Callable, *, compute=None, num_cpus: float = 1.0):
        return self._with_op(MapRows(fn=fn, compute=compute, num_cpus=num_cpus))

    def map_batches(
        self,
        fn: Callable,
        *,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        compute=None,
        num_cpus: float = 1.0,
        fn_args: tuple = (),
        fn_kwargs: Optional[dict] = None,
    ):
        return self._with_op(
            MapBatches(
                fn=fn,
                batch_size=batch_size,
                batch_format=batch_format,
                fn_args=fn_args,
                fn_kwargs=fn_kwargs or {},
                compute=compute,
                num_cpus=num_cpus,
            )
        )

    def flat_map(self, fn: Callable, *, compute=None, num_cpus: float = 1.0):
        return self._with_op(FlatMap(fn=fn, compute=compute, num_cpus=num_cpus))

    def filter(self, fn: Callable, *, compute=None, num_cpus: float = 1.0):
        return self._with_op(Filter(fn=fn, compute=compute, num_cpus=num_cpus))

    def add_column(self, name: str, fn: Callable):
        """fn takes a batch (dict of ndarrays) and returns the new column."""

        def _add(batch):
            batch = dict(batch)
            batch[name] = np.asarray(fn(batch))
            return batch

        return self.map_batches(_add, batch_format="numpy")

    def drop_columns(self, cols: List[str]):
        def _drop(batch):
            return {k: v for k, v in batch.items() if k not in cols}

        return self.map_batches(_drop, batch_format="numpy")

    def select_columns(self, cols: List[str]):
        def _select(batch):
            return {k: batch[k] for k in cols}

        return self.map_batches(_select, batch_format="numpy")

    def rename_columns(self, mapping: Dict[str, str]):
        def _rename(batch):
            return {mapping.get(k, k): v for k, v in batch.items()}

        return self.map_batches(_rename, batch_format="numpy")

    def limit(self, n: int):
        return self._with_op(Limit(limit=n))

    def repartition(self, num_blocks: int, *, shuffle: bool = False):
        return self._with_op(Repartition(num_blocks=num_blocks, shuffle=shuffle))

    def random_shuffle(self, *, seed: Optional[int] = None):
        return self._with_op(RandomShuffle(seed=seed))

    def randomize_block_order(self, *, seed: Optional[int] = None):
        """Cheap shuffle: permute block order only (reference
        dataset.py randomize_block_order). Lazy: with seed=None every plan
        execution (epoch) draws a fresh permutation."""
        return self._with_op(RandomizeBlockOrder(seed=seed))

    def sort(self, key=None, *, descending: bool = False):
        return self._with_op(Sort(key=key, descending=descending))

    def groupby(self, key):
        from ray_tpu_torch.data.grouped_data import GroupedData

        return GroupedData(self, key)

    def aggregate(self, *aggs):
        """Whole-dataset aggregation: one output row (reference
        dataset.py aggregate)."""
        from ray_tpu_torch.data.grouped_data import GroupedData

        result = GroupedData(self, None).aggregate(*aggs).take_all()
        if not result:
            return None
        row = result[0]
        if len(aggs) == 1:
            return row[aggs[0].name]
        return row

    def sum(self, on=None):
        from ray_tpu_torch.data.aggregate import Sum

        return self.aggregate(Sum(on))

    def min(self, on=None):
        from ray_tpu_torch.data.aggregate import Min

        return self.aggregate(Min(on))

    def max(self, on=None):
        from ray_tpu_torch.data.aggregate import Max

        return self.aggregate(Max(on))

    def mean(self, on=None):
        from ray_tpu_torch.data.aggregate import Mean

        return self.aggregate(Mean(on))

    def std(self, on=None, ddof: int = 1):
        from ray_tpu_torch.data.aggregate import Std

        return self.aggregate(Std(on, ddof))

    def union(self, *others: "Dataset"):
        return self._with_op(UnionOp(others=[o._plan for o in others]))

    def zip(self, other: "Dataset"):
        return self._with_op(Zip(other=other._plan))

    # ------------------------------------------------------------------
    # Splits
    # ------------------------------------------------------------------

    def split(self, n: int, *, equal: bool = False) -> List["MaterializedDataset"]:
        bundles = self._materialize_bundles()
        if equal:
            return [
                _dataset_from_bundles(list(s))
                for s in _split_equal(bundles, n)
            ]
        shards: List[List[RefBundle]] = [[] for _ in range(n)]
        for i, b in enumerate(bundles):
            shards[i % n].append(b)
        return [_dataset_from_bundles(s) for s in shards]

    def split_at_indices(self, indices: List[int]) -> List["MaterializedDataset"]:
        """Ref-level split: blocks are sliced only at boundaries; rows never
        pass through the driver (reference dataset.py split_at_indices)."""
        bundles = self._materialize_bundles()
        shards = _split_at_row_indices(bundles, sorted(indices))
        return [_dataset_from_bundles(s) for s in shards]

    def split_proportionately(self, proportions: List[float]):
        n = self.count()
        indices = []
        acc = 0.0
        for p in proportions:
            acc += p
            indices.append(int(n * acc))
        return self.split_at_indices(indices)

    def train_test_split(
        self, test_size: float, *, shuffle: bool = False, seed=None
    ):
        ds = self.random_shuffle(seed=seed) if shuffle else self
        train, test = ds.split_proportionately([1.0 - test_size])
        return train, test

    def streaming_split(
        self, n: int, *, equal: bool = False, locality_hints=None
    ) -> List[DataIterator]:
        """N coordinated iterators over ONE pass of the stream — the per-worker
        shard primitive Train consumes (reference dataset.py:1089 +
        operators/output_splitter.py)."""
        coord = _SplitCoordinator(self._make_stream, n, equal)
        return [
            DataIterator(lambda rank=rank: coord.stream_for(rank), owner=self)
            for rank in range(n)
        ]

    # ------------------------------------------------------------------
    # Execution / consumption
    # ------------------------------------------------------------------

    def _make_stream(self) -> Iterator[RefBundle]:
        return execute_streaming(self._plan, self._stats)

    def _materialize_bundles(self) -> List[RefBundle]:
        return list(self._make_stream())

    def materialize(self) -> "MaterializedDataset":
        return _dataset_from_bundles(self._materialize_bundles())

    def iterator(self) -> DataIterator:
        return DataIterator(self._make_stream, owner=self)

    def iter_rows(self) -> Iterator[Any]:
        return self.iterator().iter_rows()

    def iter_batches(self, **kwargs) -> Iterator[Any]:
        return self.iterator().iter_batches(**kwargs)

    def iter_device_batches(self, **kwargs) -> Iterator[Any]:
        """Batches as dicts of tensors on `device` ("cuda" by default; see
        DataIterator.iter_device_batches)."""
        return self.iterator().iter_device_batches(**kwargs)

    def iter_torch_batches(self, *, batch_size: int = 256, **kwargs):
        """Batches as dicts of host tensors (`torch.as_tensor` of the numpy
        columns, numpy's dtypes kept)."""
        import torch

        for batch in self.iter_batches(
            batch_size=batch_size, batch_format="numpy", **kwargs
        ):
            yield {k: torch.as_tensor(v) for k, v in batch.items()}

    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def take_all(self) -> List[Any]:
        return list(self.iter_rows())

    def take_batch(self, batch_size: int = 20, *, batch_format: str = "numpy"):
        rows = self.take(batch_size)
        return batch_to_format(rows, batch_format)

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def count(self) -> int:
        total = 0
        for _, meta in self._make_stream():
            total += meta.num_rows or 0
        return total

    def schema(self):
        for ref, meta in self._make_stream():
            if meta.schema is not None:
                return meta.schema
            return BlockAccessor.for_block(ray_tpu_torch.get(ref)).schema()
        return None

    def columns(self) -> Optional[List[str]]:
        s = self.schema()
        if isinstance(s, dict):
            return list(s)
        try:
            return list(s.names)  # pyarrow schema
        except AttributeError:
            return None

    def num_blocks(self) -> int:
        return len(self._materialize_bundles())

    def size_bytes(self) -> int:
        return sum(m.size_bytes or 0 for _, m in self._make_stream())

    def input_files(self) -> List[str]:
        files: List[str] = []
        for op in self._plan.ops:
            files.extend(getattr(op, "input_files", []) or [])
        return files

    def to_pandas(self):
        import pandas as pd

        frames = [
            BlockAccessor.for_block(ray_tpu_torch.get(ref)).to_pandas()
            for ref, _ in self._make_stream()
        ]
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, ignore_index=True)

    def to_arrow_refs(self) -> List[Any]:
        def _to_arrow(block):
            return BlockAccessor.for_block(block).to_arrow()

        conv = ray_tpu_torch.remote(_to_arrow)
        return [conv.remote(ref) for ref, _ in self._make_stream()]

    def to_numpy_refs(self) -> List[Any]:
        def _to_np(block):
            return BlockAccessor.for_block(block).to_numpy_dict()

        conv = ray_tpu_torch.remote(_to_np)
        return [conv.remote(ref) for ref, _ in self._make_stream()]

    def get_internal_block_refs(self) -> List[Any]:
        return [ref for ref, _ in self._materialize_bundles()]

    # ------------------------------------------------------------------
    # Writes (reference data/dataset.py write_parquet/csv/json + datasink)
    # ------------------------------------------------------------------

    def _write(self, path: str, writer: Callable, ext: str) -> List[str]:
        import os

        os.makedirs(path, exist_ok=True)

        def _write_block(block, out_path):
            writer(BlockAccessor.for_block(block), out_path)
            return out_path

        wtask = ray_tpu_torch.remote(_write_block)
        refs = []
        for i, (ref, _) in enumerate(self._make_stream()):
            out_path = os.path.join(path, f"{i:06d}.{ext}")
            refs.append(wtask.remote(ref, out_path))
        return ray_tpu_torch.get(refs)

    def write_parquet(self, path: str) -> List[str]:
        def _w(acc, p):
            import pyarrow.parquet as pq

            pq.write_table(acc.to_arrow(), p)

        return self._write(path, _w, "parquet")

    def write_csv(self, path: str) -> List[str]:
        def _w(acc, p):
            acc.to_pandas().to_csv(p, index=False)

        return self._write(path, _w, "csv")

    def write_json(self, path: str) -> List[str]:
        def _w(acc, p):
            acc.to_pandas().to_json(p, orient="records", lines=True)

        return self._write(path, _w, "json")

    def write_tfrecords(self, path: str) -> List[str]:
        """One TFRecord file per block; rows become tf.train.Example records
        (native codec, ray_tpu/data/tfrecords.py — no TF dependency)."""

        def _w(acc, p):
            from ray_tpu_torch.data.tfrecords import encode_example, write_records

            write_records(
                p, (encode_example(row) for row in acc.iter_rows())
            )

        return self._write(path, _w, "tfrecords")

    def write_numpy(self, path: str, column: str = "data") -> List[str]:
        def _w(acc, p):
            np.save(p, acc.to_numpy_dict()[column])

        return self._write(path, _w, "npy")

    # ------------------------------------------------------------------

    def stats(self) -> str:
        """Per-operator execution breakdown (reference data/_internal/stats.py
        — the main input-pipeline perf tool; populated during execution,
        including consumption through iter_batches/streaming_split):
        blocks/rows/bytes produced, task wall-time distribution, per-stage
        throughput, and the stage's streaming wall clock."""
        from ray_tpu_torch.data._internal.executor import dominant_stage

        lines = [f"Dataset plan: {self._plan.describe()}"]
        for idx, (stage, s) in enumerate(self._stats.items(), 1):
            blocks = s.get("blocks", 0)
            wall = s.get("wall_s", 0.0)
            lines.append(
                f"Stage {idx} {stage}: {blocks} blocks produced in {wall:.2f}s"
            )
            if s.get("rows"):
                rate = f" ({s['rows'] / wall:.0f} rows/s)" if wall > 0 else ""
                lines.append(f"* Output rows: {s['rows']} total{rate}")
            if s.get("bytes"):
                lines.append(f"* Output size bytes: {s['bytes']} total")
            walls = s.get("task_wall_s") or []
            if walls:
                lines.append(
                    f"* Tasks: {len(walls)}; task wall time: "
                    f"{min(walls)*1e3:.1f}ms min, "
                    f"{sum(walls)/len(walls)*1e3:.1f}ms mean, "
                    f"{max(walls)*1e3:.1f}ms max, "
                    f"{sum(walls)*1e3:.1f}ms total"
                )
        slowest = dominant_stage(self._stats)
        if slowest is not None:
            lines.append(
                f"Slowest stage: {slowest[0]} ({slowest[1]*1e3:.1f}ms execution)"
            )
        return "\n".join(lines)

    def stats_dict(self) -> Dict[str, dict]:
        """The raw per-stage counters behind stats() (latest execution) —
        what the train profiler reads to blame data_wait on an operator."""
        return {stage: dict(s) for stage, s in self._stats.items()}

    def __repr__(self):
        return f"Dataset(plan={self._plan.describe()})"


class MaterializedDataset(Dataset):
    """A Dataset whose blocks are already in the object store."""

    def __init__(self, plan: LogicalPlan, bundles: List[RefBundle]):
        super().__init__(plan)
        self._bundles = bundles

    def num_blocks(self) -> int:
        return len(self._bundles)

    def count(self) -> int:
        return sum(m.num_rows or 0 for _, m in self._bundles)


def _split_at_row_indices(
    bundles: List[RefBundle], boundaries: List[int]
) -> List[List[RefBundle]]:
    """Slice a bundle list at absolute row indices. Whole blocks are passed by
    reference; blocks straddling a boundary are sliced once and re-put.
    Returns len(boundaries)+1 shards."""

    def put_slice(ref, block, start, end):
        if block is None:
            block = ray_tpu_torch.get(ref)
        piece = BlockAccessor.for_block(block).slice(start, end)
        meta = BlockAccessor.for_block(piece).metadata()
        return block, (ray_tpu_torch.put(piece), meta)

    shards: List[List[RefBundle]] = []
    cur: List[RefBundle] = []
    bi = 0
    pos = 0  # absolute row index of the current block's start
    for ref, meta in bundles:
        n_rows = meta.num_rows or 0
        block_cache = None
        offset = 0
        while offset < n_rows:
            if bi >= len(boundaries):
                # Tail shard takes everything remaining.
                if offset == 0:
                    cur.append((ref, meta))
                else:
                    block_cache, bundle = put_slice(ref, block_cache, offset, n_rows)
                    cur.append(bundle)
                offset = n_rows
                continue
            need = boundaries[bi] - (pos + offset)
            if need <= 0:
                shards.append(cur)
                cur = []
                bi += 1
                continue
            avail = n_rows - offset
            if avail <= need:
                if offset == 0:
                    cur.append((ref, meta))
                else:
                    block_cache, bundle = put_slice(ref, block_cache, offset, n_rows)
                    cur.append(bundle)
                offset = n_rows
            else:
                block_cache, bundle = put_slice(
                    ref, block_cache, offset, offset + need
                )
                cur.append(bundle)
                offset += need
        pos += n_rows
    shards.append(cur)
    while len(shards) < len(boundaries) + 1:
        shards.append([])
    return shards


def _split_equal(bundles: List[RefBundle], n: int):
    """Split bundles into n exactly-equal shards of total//n rows each,
    slicing blocks at boundaries and DROPPING the remainder (the reference's
    split(equal=True) contract: shards are exactly equal)."""
    rows_total = sum(m.num_rows or 0 for _, m in bundles)
    per = rows_total // n
    if per == 0:
        return [[] for _ in range(n)]
    boundaries = [per * i for i in range(1, n + 1)]
    return _split_at_row_indices(bundles, boundaries)[:n]


def from_items_materialized(items: List[Any]) -> MaterializedDataset:
    acc = BlockAccessor.for_block(list(items))
    ref = ray_tpu_torch.put(list(items))
    return _dataset_from_bundles([(ref, acc.metadata())])
