"""Block: the unit of distributed data.

Reference: python/ray/data/block.py — a Block is one of {list of rows,
pyarrow.Table, pandas.DataFrame}, always manipulated through a `BlockAccessor`
(block.py:276) so operators are format-agnostic; `BlockMetadata` (block.py:255)
travels with every block ref so planning never needs to fetch data.

Addition over the reference: a dict-of-numpy "tensor block" format, the
zero-copy feeding format for `iter_batches(batch_format="numpy")` →
`iter_device_batches` (pinned host tensors copied to the card).

pandas and pyarrow are optional: a block is told apart by its type's module,
so either package is imported only when a block is one of theirs or a caller
asks for its format (`batch_format="pandas"`, a parquet/csv/json file).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np

# NOTE: arrow calls here run concurrently from task threads. That is safe
# ONLY because ray_tpu_torch/__init__.py sets ARROW_DEFAULT_MEMORY_POOL=system
# (unless the caller chose a pool): pyarrow's bundled jemalloc pool can
# corrupt itself under thread churn and segfault in later arrow/pandas calls.

Block = Any  # list | pyarrow.Table | pandas.DataFrame | dict[str, np.ndarray]


@dataclass
class BlockMetadata:
    num_rows: Optional[int] = None
    size_bytes: Optional[int] = None
    schema: Any = None
    input_files: Optional[List[str]] = None
    exec_stats: Optional[dict] = None


def _is_arrow_table(block: Any) -> bool:
    """True for a pyarrow.Table; imports pyarrow only when the block's type
    comes from it (then it is already imported)."""
    if not type(block).__module__.startswith("pyarrow"):
        return False
    import pyarrow as pa

    return isinstance(block, pa.Table)


def _is_pandas_frame(block: Any) -> bool:
    """True for a pandas.DataFrame; imports pandas only when the block's
    type comes from it."""
    if not type(block).__module__.startswith("pandas"):
        return False
    import pandas as pd

    return isinstance(block, pd.DataFrame)


def _is_tensor_block(block: Any) -> bool:
    return isinstance(block, dict) and all(
        isinstance(v, np.ndarray) for v in block.values()
    )


class BlockAccessor:
    """Format-agnostic view over one block."""

    def __init__(self, block: Block):
        self._block = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        if _is_arrow_table(block):
            return ArrowBlockAccessor(block)
        if _is_pandas_frame(block):
            return PandasBlockAccessor(block)
        if _is_tensor_block(block):
            return TensorBlockAccessor(block)
        if isinstance(block, list):
            return SimpleBlockAccessor(block)
        raise TypeError(f"Unsupported block type: {type(block)}")

    # -- interface -------------------------------------------------------
    def num_rows(self) -> int:
        raise NotImplementedError

    def size_bytes(self) -> int:
        raise NotImplementedError

    def schema(self) -> Any:
        raise NotImplementedError

    def iter_rows(self) -> Iterator[Any]:
        raise NotImplementedError

    def slice(self, start: int, end: int) -> Block:
        raise NotImplementedError

    def to_pylist(self) -> list:
        return list(self.iter_rows())

    def to_numpy_dict(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self.to_numpy_dict())

    def to_arrow(self):
        import pyarrow as pa

        return pa.Table.from_pydict(dict(self.to_numpy_dict()))

    def take_columns(self, keys) -> Block:
        d = self.to_numpy_dict()
        return {k: d[k] for k in keys}

    def metadata(self, input_files=None, exec_stats=None) -> BlockMetadata:
        return BlockMetadata(
            num_rows=self.num_rows(),
            size_bytes=self.size_bytes(),
            schema=self.schema(),
            input_files=input_files,
            exec_stats=exec_stats,
        )

    @property
    def block(self) -> Block:
        return self._block


class SimpleBlockAccessor(BlockAccessor):
    def num_rows(self) -> int:
        return len(self._block)

    def size_bytes(self) -> int:
        return sum(sys.getsizeof(r) for r in self._block[:100]) * max(
            1, len(self._block) // max(1, min(100, len(self._block)))
        )

    def schema(self) -> Any:
        if not self._block:
            return None
        row = self._block[0]
        if isinstance(row, dict):
            return {k: type(v).__name__ for k, v in row.items()}
        return type(row).__name__

    def iter_rows(self):
        return iter(self._block)

    def slice(self, start, end):
        return self._block[start:end]

    def to_numpy_dict(self):
        if self._block and isinstance(self._block[0], dict):
            keys = self._block[0].keys()
            return {k: np.asarray([r[k] for r in self._block]) for k in keys}
        return {"value": np.asarray(self._block)}


class TensorBlockAccessor(BlockAccessor):
    def num_rows(self) -> int:
        if not self._block:
            return 0
        return len(next(iter(self._block.values())))

    def size_bytes(self) -> int:
        return int(sum(v.nbytes for v in self._block.values()))

    def schema(self) -> Any:
        return {k: (v.dtype.name, v.shape[1:]) for k, v in self._block.items()}

    def iter_rows(self):
        keys = list(self._block.keys())
        for i in range(self.num_rows()):
            yield {k: self._block[k][i] for k in keys}

    def slice(self, start, end):
        return {k: v[start:end] for k, v in self._block.items()}

    def to_numpy_dict(self):
        return self._block


class ArrowBlockAccessor(BlockAccessor):
    def num_rows(self) -> int:
        return self._block.num_rows

    def size_bytes(self) -> int:
        return self._block.nbytes

    def schema(self) -> Any:
        return self._block.schema

    def iter_rows(self):
        for batch in self._block.to_batches():
            for row in batch.to_pylist():
                yield row

    def slice(self, start, end):
        return self._block.slice(start, end - start)

    def to_numpy_dict(self):
        return {
            name: np.asarray(self._block.column(name))
            for name in self._block.column_names
        }

    def to_arrow(self):
        return self._block

    def to_pandas(self):
        return self._block.to_pandas()


class PandasBlockAccessor(BlockAccessor):
    def num_rows(self) -> int:
        return len(self._block)

    def size_bytes(self) -> int:
        return int(self._block.memory_usage(deep=True).sum())

    def schema(self) -> Any:
        return {c: str(t) for c, t in self._block.dtypes.items()}

    def iter_rows(self):
        for _, row in self._block.iterrows():
            yield row.to_dict()

    def slice(self, start, end):
        return self._block.iloc[start:end]

    def to_numpy_dict(self):
        return {c: self._block[c].to_numpy() for c in self._block.columns}

    def to_pandas(self):
        return self._block


# -- builders ----------------------------------------------------------------


class DelegatingBlockBuilder:
    """Accumulate rows/batches and emit a block in the dominant format."""

    def __init__(self):
        self._rows: list = []
        self._tensor_parts: list = []
        self._tables: list = []

    def add(self, row: Any) -> None:
        self._rows.append(row)

    def add_batch(self, batch: Block) -> None:
        if _is_arrow_table(batch) or _is_pandas_frame(batch):
            self._tables.append(batch)
        elif _is_tensor_block(batch):
            self._tensor_parts.append(batch)
        elif isinstance(batch, list):
            self._rows.extend(batch)
        else:
            raise TypeError(f"Cannot add batch of type {type(batch)}")

    def num_rows(self) -> int:
        n = len(self._rows)
        for part in self._tensor_parts:
            n += TensorBlockAccessor(part).num_rows()
        for t in self._tables:
            n += len(t)
        return n

    def build(self) -> Block:
        if self._tables:
            tables = self._tables
            if self._rows or self._tensor_parts:
                raise ValueError("Mixed block formats in one builder")
            if _is_arrow_table(tables[0]):
                import pyarrow as pa

                return pa.concat_tables(tables)
            import pandas as pd

            return pd.concat(tables, ignore_index=True)
        if self._tensor_parts:
            if self._rows:
                raise ValueError("Mixed block formats in one builder")
            keys = self._tensor_parts[0].keys()
            return {
                k: np.concatenate([p[k] for p in self._tensor_parts])
                for k in keys
            }
        return list(self._rows)


def batch_to_format(batch: Block, batch_format: str) -> Any:
    """Convert a block to the user-requested batch format."""
    acc = BlockAccessor.for_block(batch)
    if batch_format in ("numpy", "default"):
        return acc.to_numpy_dict()
    if batch_format == "pandas":
        return acc.to_pandas()
    if batch_format in ("pyarrow", "arrow"):
        return acc.to_arrow()
    if batch_format in ("native", "rows", "list"):
        return acc.to_pylist()
    raise ValueError(f"Unknown batch_format {batch_format!r}")
