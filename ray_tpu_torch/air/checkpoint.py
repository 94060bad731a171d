"""Uniform checkpoint object (reference: air/checkpoint.py:66 — dict ⇄ directory
⇄ URI forms with lazy conversion).

Tensor leaves of a dict checkpoint may live on the card. A directory holds
them on the CPU, bit for bit (`to_directory` copies every tensor leaf to the
host before pickling); `train.prepare_params` moves them back to the
worker's device. Sharded checkpoints wait for the parallel layer
(ROADMAP.md §B7)."""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import uuid
from typing import Any, Optional

import torch

_PAYLOAD_FILE = "checkpoint.pkl"


def _to_host(value: Any) -> Any:
    """Copy every tensor leaf of a dict/list/tuple tree to the CPU (values
    unchanged, bit for bit); other leaves pass through."""
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_host(v) for v in value)
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return value


class Checkpoint:
    """Either an in-memory dict or a directory on disk; converts lazily."""

    def __init__(
        self,
        data: Optional[dict] = None,
        path: Optional[str] = None,
    ):
        if (data is None) == (path is None):
            raise ValueError("Provide exactly one of data= or path=")
        self._data = data
        self._path = path
        self.id = uuid.uuid4().hex[:12]

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_dict(cls, data: dict) -> "Checkpoint":
        # Train-profiler hook: checkpoint construction inside an
        # instrumented training session counts as the round's `checkpoint`
        # phase (and is the per-rank fault-injection site train.checkpoint).
        from ray_tpu_torch.train.observability import phase_or_null

        with phase_or_null("checkpoint"):
            return cls(data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path=path)

    # -- accessors ----------------------------------------------------------

    def to_dict(self) -> dict:
        if self._data is not None:
            return dict(self._data)
        payload = os.path.join(self._path, _PAYLOAD_FILE)
        if os.path.exists(payload):
            with open(payload, "rb") as f:
                return pickle.load(f)
        raise ValueError(
            f"Directory checkpoint at {self._path} has no {_PAYLOAD_FILE}; "
            "use to_directory() / as_directory() for raw-file checkpoints"
        )

    def to_directory(self, path: Optional[str] = None) -> str:
        if path is None:
            path = tempfile.mkdtemp(prefix="ray_tpu_ckpt_")
        os.makedirs(path, exist_ok=True)
        if self._path is not None:
            if os.path.abspath(self._path) != os.path.abspath(path):
                shutil.copytree(self._path, path, dirs_exist_ok=True)
        else:
            with open(os.path.join(path, _PAYLOAD_FILE), "wb") as f:
                pickle.dump(_to_host(self._data), f)
        return path

    def as_directory(self):
        """Context manager yielding a directory view."""
        import contextlib

        @contextlib.contextmanager
        def cm():
            if self._path is not None:
                yield self._path
            else:
                tmp = self.to_directory()
                try:
                    yield tmp
                finally:
                    shutil.rmtree(tmp, ignore_errors=True)

        return cm()

    def __repr__(self):
        kind = "dict" if self._data is not None else f"dir:{self._path}"
        return f"Checkpoint({kind})"
