"""Worker log aggregation.

The reference runs a per-node log_monitor process that tails worker log
files and publishes lines over GCS pubsub; the driver subscribes and
reprints them with `(name pid=..., ip=...)` prefixes
(python/ray/_private/log_monitor.py:102, worker.py print_logs). In the port
the worker processes are the driver's children, so their stdout/stderr
pipes are tailed on the driver itself:

  worker pipe → PipeTailer thread → LogBuffer ring (`Runtime.logs`)
      → driver stdout/stderr with a `(worker pid=…)` prefix

Node daemons, the dashboard, client mode and the CLI, which the reference
also feeds from here, are not ported yet (ROADMAP.md §B10, §B13).
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
    """Driver-side ring buffer of worker log lines, queryable by worker pid.
    Each appended batch also goes to `sink` when one is given (the driver
    reprint of log_to_driver)."""

    def __init__(
        self,
        capacity: int = 50_000,
        sink: Optional[Callable[[dict], None]] = None,
    ):
        self._lock = threading.Lock()
        self._lines: deque = deque(maxlen=capacity)
        self._sink = sink

    def append(self, *, pid: int, stream: str, lines: Iterable[str]) -> None:
        batch = {
            "pid": pid,
            "stream": stream,
            "lines": [line.rstrip("\n") for line in lines],
        }
        if not batch["lines"]:
            return
        ts = time.time()
        with self._lock:
            for line in batch["lines"]:
                self._lines.append(
                    {"pid": pid, "stream": stream, "line": line, "ts": ts}
                )
        if self._sink is not None:
            try:
                self._sink(batch)
            except Exception:
                pass

    def tail(self, *, pid: Optional[int] = None, limit: int = 1000) -> list[dict]:
        """The newest `limit` lines, oldest first; only worker `pid`'s when
        given. Collected by reverse scan, so the lock is held for at most
        `limit` copies."""
        rows = []
        with self._lock:
            for row in reversed(self._lines):
                if pid is None or row["pid"] == pid:
                    rows.append(dict(row))
                    if len(rows) >= limit:
                        break
        return rows[::-1]


def format_prefix(batch: dict) -> str:
    return f"{_PREFIX_COLOR}(worker pid={batch['pid']}){_RESET}"


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
