"""Offline RL IO — write rollouts out, read experience back in.

Reference: rllib/offline/ (JsonWriter/JsonReader + dataset-based IO). Batches
persist as JSON-lines of column dicts (human-greppable, append-friendly);
readers shuffle across files and yield SampleBatches for off-policy or
imitation training. `config.output` on any algorithm tees sampled rollouts to
a writer; `BC` (algorithms/bc) trains purely from a reader with no env
interaction.
"""

from __future__ import annotations

import base64
import json
import os
import uuid
from typing import Iterator, List, Optional

import numpy as np

from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch


def _encode_column(arr) -> dict:
    arr = np.asarray(arr)
    return {
        "dtype": str(arr.dtype),
        "shape": list(arr.shape),
        "data": base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode(),
    }


def _decode_column(spec: dict) -> np.ndarray:
    return np.frombuffer(
        base64.b64decode(spec["data"]), dtype=np.dtype(spec["dtype"])
    ).reshape(spec["shape"])


class JsonWriter:
    """Appends SampleBatches to .jsonl files under a directory (one line per
    batch; reference: rllib/offline/json_writer.py)."""

    def __init__(self, path: str, max_file_size_mb: float = 64.0):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._max_bytes = int(max_file_size_mb * 1024 * 1024)
        self._file = None
        self._written = 0

    def _rotate(self) -> None:
        if self._file is not None:
            self._file.close()
        fname = os.path.join(self.path, f"batches-{uuid.uuid4().hex[:8]}.jsonl")
        self._file = open(fname, "a")
        self._written = 0

    def write(self, batch: SampleBatch) -> None:
        if self._file is None or self._written > self._max_bytes:
            self._rotate()
        record = {
            k: _encode_column(v)
            for k, v in batch.items()
            if k != SampleBatch.INFOS
        }
        line = json.dumps(record)
        self._file.write(line + "\n")
        self._file.flush()
        self._written += len(line)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class JsonReader:
    """Streams batches back, cycling over files forever (training loops
    decide how much to consume; reference: rllib/offline/json_reader.py).
    Never materializes the dataset: one line is decoded at a time, so
    multi-GB logs read in constant memory. `shuffle` permutes FILE order per
    epoch (lines stream in order within a file — draw train batches with
    sample_rows for row-level mixing)."""

    def __init__(self, path: str, shuffle: bool = True, seed: Optional[int] = None):
        self.path = path
        self._rng = np.random.default_rng(seed)
        self._shuffle = shuffle
        self._files = sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.endswith(".jsonl")
        )
        if not self._files:
            raise FileNotFoundError(f"No .jsonl batch files under {path!r}")
        if self._shuffle:
            self._rng.shuffle(self._files)
        self._file_idx = 0
        self._fh = None

    def next(self) -> SampleBatch:
        while True:
            if self._fh is None:
                self._fh = open(self._files[self._file_idx])
            line = self._fh.readline()
            if not line:
                self._fh.close()
                self._fh = None
                self._file_idx += 1
                if self._file_idx >= len(self._files):
                    self._file_idx = 0
                    if self._shuffle:
                        self._rng.shuffle(self._files)
                continue
            line = line.strip()
            if not line:
                continue
            record = json.loads(line)
            return SampleBatch(
                {k: _decode_column(v) for k, v in record.items()}
            )

    def iter_batches(self) -> Iterator[SampleBatch]:
        while True:
            yield self.next()

    def sample_rows(self, n: int) -> SampleBatch:
        """A batch of exactly n rows drawn across stored batches."""
        out: List[SampleBatch] = []
        count = 0
        while count < n:
            b = self.next()
            out.append(b)
            count += b.count
        merged = SampleBatch.concat_samples(out)
        if merged.count > n:
            start = int(self._rng.integers(0, merged.count - n + 1))
            merged = merged.slice(start, start + n)
        return merged


from ray_tpu_torch.rllib.offline.estimators import (  # noqa: E402
    ImportanceSampling,
    OffPolicyEstimator,
    WeightedImportanceSampling,
    estimate_from_reader,
)

__all__ = [
    "ImportanceSampling",
    "JsonReader",
    "JsonWriter",
    "OffPolicyEstimator",
    "WeightedImportanceSampling",
    "estimate_from_reader",
]
