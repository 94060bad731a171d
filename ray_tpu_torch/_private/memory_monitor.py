"""Host-memory monitor + OOM worker-killing policy.

Re-design of the reference's memory monitor (common/memory_monitor.h:52 —
a raylet thread sampling /proc and invoking a worker-killing policy) and its
retriable-FIFO policy (raylet/worker_killing_policy_retriable_fifo.h): when
host memory crosses the usage threshold,

  1. dispatch is backpressured (the scheduler stops handing out new leases),
  2. the policy picks a victim — workers running RETRIABLE work first,
     newest task first (killing the newest loses the least progress and the
     retry will re-run it after pressure clears), largest RSS as tiebreak,
  3. the victim process is killed with an OOM death note: its task fails
     with exceptions.OutOfMemoryError and retries through the normal
     system-failure path instead of the host OOM-killer taking down the
     whole runtime.

Only process-backed workers (ProcessNodeEngine and companions) are
killable; threaded in-process tasks cannot be safely destroyed.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional


def system_memory_fraction() -> float:
    """Used fraction of host memory, from /proc/meminfo (MemAvailable)."""
    total = avail = None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1])
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1])
                if total is not None and avail is not None:
                    break
    except OSError:
        return 0.0
    if not total or avail is None:
        return 0.0
    return 1.0 - (avail / total)


def worker_rss_bytes(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return 0


class MemoryMonitor:
    def __init__(
        self,
        runtime,
        threshold: float,
        period_s: float,
        memory_fraction_fn: Callable[[], float] = system_memory_fraction,
        kill_cooldown_ticks: int = 5,
    ):
        self.runtime = runtime
        self.threshold = threshold
        self.period_s = period_s
        self._memory_fraction = memory_fraction_fn
        self.under_pressure = False
        self.kills = 0
        self._cooldown = 0
        self._kill_cooldown_ticks = max(1, kill_cooldown_ticks)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="memory-monitor", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    # -- sampling loop ------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self._tick()
            except Exception:
                pass  # monitoring must never take the runtime down

    def _tick(self) -> None:
        frac = self._memory_fraction()
        pressured = frac >= self.threshold
        if pressured != self.under_pressure:
            self.under_pressure = pressured
            if not pressured:
                # Pressure cleared: wake the scheduler for backpressured work.
                self.runtime.scheduler.notify()
        if self._cooldown > 0:
            self._cooldown -= 1
        if pressured and self._cooldown == 0:
            if self._kill_one():
                # Give the OS a few periods to reap the victim and for the
                # freed memory to register before choosing another.
                self._cooldown = self._kill_cooldown_ticks

    # -- policy -------------------------------------------------------------

    def _candidates(self):
        """(handle, engine) for every live process-backed worker."""
        from ray_tpu_torch._private.process_engine import ProcessNodeEngine

        with self.runtime._lock:
            engines = list(self.runtime.engines.values()) + list(
                self.runtime._companions.values()
            )
        out = []
        for engine in engines:
            if not isinstance(engine, ProcessNodeEngine):
                continue
            with engine._lock:
                workers = list(engine._workers)
            for handle in workers:
                if not handle.expected_death:
                    out.append((handle, engine))
        return out

    @staticmethod
    def _retriable(handle) -> bool:
        """True when every in-flight task on the worker has retries left —
        killing it loses no work permanently."""
        with handle._lock:
            entries = list(handle.in_flight.values())
        if not entries:
            return False
        for spec, _ in entries:
            if spec.max_retries == 0:
                return False
        return True

    def _kill_one(self) -> bool:
        """Retriable-FIFO: retriable workers first, newest first, then
        largest RSS (worker_killing_policy_retriable_fifo.h ordering).
        Returns True when a victim was killed."""
        candidates = self._candidates()
        busy = [(h, e) for h, e in candidates if h.in_flight]
        if not busy:
            return False
        ranked = sorted(
            busy,
            key=lambda he: (
                not self._retriable(he[0]),  # retriable first
                -he[0].last_dispatch,  # newest task first: least progress lost
                -worker_rss_bytes(he[0].proc.pid),  # biggest as tiebreak
            ),
        )
        handle, engine = ranked[0]
        rss_mb = worker_rss_bytes(handle.proc.pid) // (1 << 20)
        handle.death_note = (
            f"worker (pid {handle.proc.pid}, rss {rss_mb} MB) killed by the "
            f"memory monitor: host memory above "
            f"{self.threshold:.0%} threshold. The task will retry if it has "
            "retries remaining; reduce per-task memory or add resources."
        )
        self.kills += 1
        try:
            handle.proc.kill()
        except Exception:
            pass
        return True
