"""Cross-node worker log aggregation.

The reference runs a per-node log_monitor process that tails worker log
files and publishes lines over GCS pubsub; the driver subscribes and
reprints them with `(name pid=..., ip=...)` prefixes
(python/ray/_private/log_monitor.py:102, worker.py print_logs). Here the
worker stdout/stderr are pipes already owned by the daemon/engine process,
so lines ride the existing control connections:

  worker pipe → PipeTailer thread (node daemon or head) → "wl" frame → head
      → LogBuffer ring (`Runtime.logs`: the dashboard's /api/logs and
        `ray-tpu-torch logs`, through the `get_logs` RPC)
      → driver stdout/stderr with a `(worker pid=…, node=…)` prefix
      → connected remote drivers (client mode reprints them)
"""

from __future__ import annotations

import os
import select
import sys
import threading
import time
from collections import deque
from typing import Callable, Iterable, Optional

# Dim-cyan prefixes like the reference's log deduplicator output.
_PREFIX_COLOR = "\033[36m"
_RESET = "\033[0m"


class LogBuffer:
    """Head-side ring buffer of worker log lines, queryable by node and
    worker, with a cursor (`seq`). Mirrors dashboard/modules/log's role:
    the one place the dashboard and `logs` read from. Each appended batch
    also goes to every sink: the driver's reprint (log_to_driver) and the
    head server's fan-out to remote drivers."""

    def __init__(self, capacity: int = 50_000):
        self._lock = threading.Lock()
        self._lines: deque = deque(maxlen=capacity)
        self._seq = 0
        self._sinks: list[Callable[[dict], None]] = []

    def add_sink(self, sink: Callable[[dict], None]) -> None:
        """Register a callback invoked once per appended batch (driver
        printing, client fanout)."""
        with self._lock:
            self._sinks.append(sink)

    def remove_sink(self, sink: Callable[[dict], None]) -> None:
        with self._lock:
            try:
                self._sinks.remove(sink)
            except ValueError:
                pass

    def append(
        self,
        *,
        node_id: str,
        hostname: str,
        wid: int,
        pid: int,
        stream: str,
        lines: Iterable[str],
    ) -> None:
        batch = {
            "node_id": node_id,
            "hostname": hostname,
            "wid": wid,
            "pid": pid,
            "stream": stream,
            "lines": [line.rstrip("\n") for line in lines],
            "ts": time.time(),
        }
        if not batch["lines"]:
            return
        with self._lock:
            for line in batch["lines"]:
                self._seq += 1
                self._lines.append(
                    {
                        "seq": self._seq,
                        "node_id": node_id,
                        "hostname": hostname,
                        "wid": wid,
                        "pid": pid,
                        "stream": stream,
                        "line": line,
                        "ts": batch["ts"],
                    }
                )
            sinks = list(self._sinks)
        for sink in sinks:
            try:
                sink(batch)
            except Exception:
                pass

    def tail(
        self,
        *,
        node_id: Optional[str] = None,
        wid: Optional[int] = None,
        pid: Optional[int] = None,
        after_seq: Optional[int] = None,
        limit: int = 1000,
    ) -> list[dict]:
        """With after_seq (0 = from the start): the OLDEST `limit` rows
        newer than it, so a cursor-advancing poller never skips buffered
        lines. Without (None): the newest `limit` rows (dashboard view),
        oldest first, collected by reverse scan so the lock is held for at
        most `limit` copies, not a full-ring scan."""
        match = lambda row: (
            (node_id is None or row["node_id"] == node_id)
            and (wid is None or row["wid"] == wid)
            and (pid is None or row["pid"] == pid)
        )
        rows = []
        with self._lock:
            if after_seq is not None:
                for row in self._lines:
                    if row["seq"] > after_seq and match(row):
                        rows.append(dict(row))
                        if len(rows) >= limit:
                            break
                return rows
            for row in reversed(self._lines):
                if match(row):
                    rows.append(dict(row))
                    if len(rows) >= limit:
                        break
        return rows[::-1]


def format_prefix(batch: dict) -> str:
    return (
        f"{_PREFIX_COLOR}(worker pid={batch['pid']}, "
        f"node={batch['hostname']}){_RESET}"
    )


def print_batch_to_driver(batch: dict, file=None) -> None:
    """Reprint a worker log batch on the driver with a source prefix, the
    `worker.py print_logs` analog."""
    out = file or (sys.stderr if batch["stream"] == "stderr" else sys.stdout)
    prefix = format_prefix(batch)
    for line in batch["lines"]:
        print(f"{prefix} {line}", file=out, flush=True)


class PipeTailer:
    """Tails one worker pipe fd and flushes line batches to a callback.

    select()-based with a flush deadline so a lone `print()` reaches the
    driver within ~200 ms while bursts batch into one frame (the reference
    log monitor's 100-lines-or-flush-interval policy,
    log_monitor.py:387)."""

    FLUSH_INTERVAL_S = 0.2
    MAX_BATCH = 200

    def __init__(
        self,
        fd: int,
        stream: str,
        emit: Callable[[str, list], None],
        close_fd: bool = False,
    ):
        self.fd = fd
        self.stream = stream
        self.emit = emit
        self._close_fd = close_fd
        self._thread = threading.Thread(
            target=self._run, name=f"logtail-{stream}-{fd}", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait until the pipe reached its end and every line was emitted."""
        self._thread.join(timeout)

    def _run(self) -> None:
        buf = b""
        pending: list[str] = []
        deadline = None
        try:
            while True:
                timeout = None
                if pending:
                    timeout = max(0.0, deadline - time.monotonic())
                ready, _, _ = select.select([self.fd], [], [], timeout)
                if not ready:
                    self._flush(pending)
                    pending, deadline = [], None
                    continue
                try:
                    chunk = os.read(self.fd, 65536)
                except OSError:
                    chunk = b""
                if not chunk:
                    break
                buf += chunk
                *lines, buf = buf.split(b"\n")
                for raw in lines:
                    if not pending:
                        deadline = time.monotonic() + self.FLUSH_INTERVAL_S
                    pending.append(raw.decode("utf-8", "replace"))
                    if len(pending) >= self.MAX_BATCH:
                        self._flush(pending)
                        pending, deadline = [], None
        finally:
            if buf:
                pending.append(buf.decode("utf-8", "replace"))
            self._flush(pending)
            if self._close_fd:
                try:
                    os.close(self.fd)
                except OSError:
                    pass

    def _flush(self, pending: list) -> None:
        if pending:
            try:
                self.emit(self.stream, pending)
            except Exception:
                pass
