"""External storage for spilled objects: the port's copy of
ray_tpu/_private/external_storage.py (the spill directory defaults to
``$TMPDIR/ray_tpu_torch_spill_<pid>``).

Reference: raylet/local_object_manager.h:41 (SpillObjects :110,
AsyncRestoreSpilledObject :122) + _private/external_storage.py:72
(FileSystemStorage :246). When the store is over budget and nothing
unreferenced is left to evict, primary copies move to disk; ObjectRefs stay
valid and `get` restores transparently. One file per object (the reference
fuses small objects per file — an optimization, not a semantic).
"""

from __future__ import annotations

import os
import tempfile
import threading
import uuid
from typing import Any, Optional

import cloudpickle


class FileSystemStorage:
    def __init__(self, directory: Optional[str] = None):
        # The directory is created lazily on first spill, so idle runtimes
        # (most CLI invocations) never litter /tmp.
        self._owns_dir = directory is None
        self.directory = directory or os.path.join(
            tempfile.gettempdir(), f"ray_tpu_torch_spill_{os.getpid()}"
        )
        self._lock = threading.Lock()
        self._created: set = set()  # uris this storage wrote
        self.spilled_bytes = 0
        self.restored_bytes = 0
        self.num_spilled = 0
        self.num_restored = 0

    def spill(self, object_id, value: Any) -> str:
        """Serialize + persist; returns the restore URI."""
        os.makedirs(self.directory, exist_ok=True)
        data = cloudpickle.dumps(value)
        fname = f"{object_id.hex()}-{uuid.uuid4().hex[:8]}.bin"
        path = os.path.join(self.directory, fname)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        with self._lock:
            self._created.add(path)
            self.spilled_bytes += len(data)
            self.num_spilled += 1
        return path

    def restore(self, uri: str) -> Any:
        with open(uri, "rb") as f:
            data = f.read()
        with self._lock:
            self.restored_bytes += len(data)
            self.num_restored += 1
        return cloudpickle.loads(data)

    def delete(self, uri: str) -> None:
        with self._lock:
            self._created.discard(uri)
        try:
            os.unlink(uri)
        except FileNotFoundError:
            pass

    def destroy(self) -> None:
        """Remove our spill files. The directory itself is removed only when
        this storage chose it (never a user-provided directory that may hold
        unrelated files)."""
        with self._lock:
            created, self._created = self._created, set()
        for uri in created:
            try:
                os.unlink(uri)
            except OSError:
                pass
        if self._owns_dir:
            import shutil

            shutil.rmtree(self.directory, ignore_errors=True)

    def stats(self) -> dict:
        with self._lock:
            return {
                "spilled_bytes": self.spilled_bytes,
                "restored_bytes": self.restored_bytes,
                "num_spilled": self.num_spilled,
                "num_restored": self.num_restored,
            }
