"""Datasources: lazy readers producing ReadTasks.

Reference: data/datasource/ (parquet/csv/json/image/...). A `Datasource`
splits its input into `ReadTask`s — plain callables returning an iterator of
blocks — executed as remote tasks by the streaming executor (one task per
file/fragment, parallelism-bounded).
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Any, Callable, Iterable, List, Optional

import numpy as np


class Datasource:
    def get_read_tasks(self, parallelism: int) -> List[Callable]:
        raise NotImplementedError


def _expand_paths(paths) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(
                sorted(
                    os.path.join(p, f)
                    for f in os.listdir(p)
                    if not f.startswith(".")
                )
            )
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(_glob.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"No files matched {paths}")
    return out


class RangeDatasource(Datasource):
    def __init__(self, n: int, tensor_shape: Optional[tuple] = None):
        self._n = n
        self._shape = tensor_shape

    def get_read_tasks(self, parallelism: int) -> List[Callable]:
        n, shape = self._n, self._shape
        parallelism = max(1, min(parallelism, n or 1))
        tasks = []
        for i in range(parallelism):
            start = (n * i) // parallelism
            end = (n * (i + 1)) // parallelism

            def read(start=start, end=end):
                if shape is None:
                    yield [{"id": j} for j in range(start, end)]
                else:
                    ids = np.arange(start, end)
                    data = np.broadcast_to(
                        ids.reshape((-1,) + (1,) * len(shape)),
                        (end - start,) + shape,
                    ).copy()
                    yield {"data": data}

            tasks.append(read)
        return tasks


class CSVDatasource(Datasource):
    def __init__(self, paths, **arrow_kwargs):
        self._paths = _expand_paths(paths)
        self._kwargs = arrow_kwargs

    def get_read_tasks(self, parallelism: int) -> List[Callable]:
        kwargs = self._kwargs

        def make(path):
            def read():
                from pyarrow import csv

                yield csv.read_csv(path, **kwargs)

            return read

        return [make(p) for p in self._paths]


class ParquetDatasource(Datasource):
    def __init__(self, paths, columns: Optional[list] = None):
        self._paths = _expand_paths(paths)
        self._columns = columns

    def get_read_tasks(self, parallelism: int) -> List[Callable]:
        columns = self._columns

        def make(path):
            def read():
                import pyarrow.parquet as pq

                yield pq.read_table(path, columns=columns)

            return read

        return [make(p) for p in self._paths]


class JSONDatasource(Datasource):
    def __init__(self, paths):
        self._paths = _expand_paths(paths)

    def get_read_tasks(self, parallelism: int) -> List[Callable]:
        def make(path):
            def read():
                from pyarrow import json as pajson

                yield pajson.read_json(path)

            return read

        return [make(p) for p in self._paths]


class TextDatasource(Datasource):
    def __init__(self, paths, drop_empty_lines: bool = True):
        self._paths = _expand_paths(paths)
        self._drop_empty = drop_empty_lines

    def get_read_tasks(self, parallelism: int) -> List[Callable]:
        drop_empty = self._drop_empty

        def make(path):
            def read():
                with open(path) as f:
                    lines = [ln.rstrip("\n") for ln in f]
                if drop_empty:
                    lines = [ln for ln in lines if ln]
                yield [{"text": ln} for ln in lines]

            return read

        return [make(p) for p in self._paths]


class NumpyDatasource(Datasource):
    def __init__(self, paths):
        self._paths = _expand_paths(paths)

    def get_read_tasks(self, parallelism: int) -> List[Callable]:
        def make(path):
            def read():
                arr = np.load(path)
                yield {"data": arr}

            return read

        return [make(p) for p in self._paths]


class BinaryDatasource(Datasource):
    def __init__(self, paths):
        self._paths = _expand_paths(paths)

    def get_read_tasks(self, parallelism: int) -> List[Callable]:
        def make(path):
            def read():
                with open(path, "rb") as f:
                    yield [{"bytes": f.read(), "path": path}]

            return read

        return [make(p) for p in self._paths]
