"""Workflow storage: durable per-step checkpoints on a filesystem.

Reference: workflow/workflow_storage.py — keyed object store under a base
path: workflow DAG, per-step results, status, metadata. Writes are
atomic (tmp + rename) so a crash mid-write never corrupts a checkpoint.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, List, Optional

import cloudpickle

_STORAGE_ENV = "RAY_TPU_TORCH_WORKFLOW_STORAGE"
_default_base: Optional[str] = None


def set_base(path: str) -> None:
    global _default_base
    _default_base = path


def get_base() -> str:
    if _default_base:
        return _default_base
    return os.environ.get(
        _STORAGE_ENV, os.path.join(tempfile.gettempdir(), "ray_tpu_torch_workflows")
    )


class WorkflowStorage:
    def __init__(self, workflow_id: str, base: Optional[str] = None):
        self.workflow_id = workflow_id
        self.root = os.path.join(base or get_base(), workflow_id)

    # -- atomic helpers -------------------------------------------------

    def _write(self, rel: str, data: bytes) -> None:
        # Directories are created on first write only, so read-side API calls
        # (get_status/get_metadata) never create or resurrect workflow dirs.
        path = os.path.join(self.root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def _read(self, rel: str) -> Optional[bytes]:
        path = os.path.join(self.root, rel)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    # -- DAG ------------------------------------------------------------

    def save_dag(self, dag) -> None:
        self._write("dag.pkl", cloudpickle.dumps(dag))

    def load_dag(self):
        data = self._read("dag.pkl")
        if data is None:
            raise ValueError(
                f"No stored DAG for workflow {self.workflow_id!r}"
            )
        return cloudpickle.loads(data)

    # -- step results ---------------------------------------------------

    def save_step_result(self, step_id: str, value: Any) -> None:
        self._write(
            os.path.join("steps", f"{step_id}.pkl"), cloudpickle.dumps(value)
        )

    def has_step_result(self, step_id: str) -> bool:
        return os.path.exists(os.path.join(self.root, "steps", f"{step_id}.pkl"))

    def load_step_result(self, step_id: str) -> Any:
        data = self._read(os.path.join("steps", f"{step_id}.pkl"))
        if data is None:
            raise KeyError(step_id)
        return cloudpickle.loads(data)

    # -- continuations ---------------------------------------------------

    def save_continuation(self, step_id: str, dag: Any) -> None:
        """Persist the sub-DAG a step returned (workflow.continuation) so a
        crash mid-continuation resumes INTO it instead of re-running the
        producing step (reference: dynamic workflow checkpointing)."""
        self._write(
            os.path.join("continuations", f"{step_id}.pkl"),
            cloudpickle.dumps(dag),
        )

    def has_continuation(self, step_id: str) -> bool:
        return os.path.exists(
            os.path.join(self.root, "continuations", f"{step_id}.pkl")
        )

    def load_continuation(self, step_id: str) -> Any:
        data = self._read(os.path.join("continuations", f"{step_id}.pkl"))
        if data is None:
            raise KeyError(step_id)
        return cloudpickle.loads(data)

    # -- status / metadata ---------------------------------------------

    def save_status(self, status: str) -> None:
        self._write("status.json", json.dumps({"status": status}).encode())

    def load_status(self) -> Optional[str]:
        data = self._read("status.json")
        if data is None:
            return None
        return json.loads(data)["status"]

    def save_metadata(self, meta: dict) -> None:
        self._write("metadata.json", json.dumps(meta).encode())

    def load_metadata(self) -> dict:
        data = self._read("metadata.json")
        return json.loads(data) if data else {}

    def save_input(self, args: tuple, kwargs: dict) -> None:
        self._write("input.pkl", cloudpickle.dumps((args, kwargs)))

    def load_input(self) -> tuple:
        data = self._read("input.pkl")
        if data is None:
            return (), {}
        return cloudpickle.loads(data)

    def delete(self) -> None:
        import shutil

        shutil.rmtree(self.root, ignore_errors=True)


def list_workflows(base: Optional[str] = None) -> List[str]:
    root = base or get_base()
    if not os.path.isdir(root):
        return []
    return sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
