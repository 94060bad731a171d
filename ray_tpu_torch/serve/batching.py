"""@serve.batch — coalesce concurrent calls into one batched invocation.

Reference: serve/batching.py:242 (@serve.batch, _BatchQueue :64): concurrent
awaiting calls are gathered into a list, the wrapped function is invoked once
with the batch, and per-item results fan back out.

Addition over Ray's: `pad_to_bucket=True` pads every batch up to the next
power-of-two size (capped at max_batch_size) by repeating the final item, then
slices the padding back off. A model therefore sees O(log max_batch)
distinct batch shapes instead of every integer batch size (a fixed set of
launch shapes to warm, or to capture as CUDA graphs).
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable, Optional


def _next_bucket(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return min(b, cap)


class _Item:
    __slots__ = ("value", "event", "result", "error")

    def __init__(self, value):
        self.value = value
        self.event = threading.Event()
        self.result = None
        self.error = None


class _BatchQueue:
    """Collects items from concurrent caller threads; the thread that trips
    the flush condition executes the batch (reference _BatchQueue :64 uses an
    asyncio task; replicas here are threaded actors so callers cooperate)."""

    def __init__(
        self,
        fn: Callable,
        max_batch_size: int,
        batch_wait_timeout_s: float,
        pad_to_bucket: bool,
    ):
        self._fn = fn
        self._max = max_batch_size
        self._timeout = batch_wait_timeout_s
        self._pad = pad_to_bucket
        self._lock = threading.Lock()
        self._pending: list[_Item] = []
        # True while a flusher thread is committed to draining _pending;
        # transitions happen only under _lock so a submit can never race a
        # flusher that has already decided to exit.
        self._flusher_active = False

    def submit(self, instance, value) -> Any:
        item = _Item(value)
        run_now = False
        with self._lock:
            self._pending.append(item)
            if len(self._pending) >= self._max:
                batch = self._drain()
                run_now = True
            elif not self._flusher_active:
                self._flusher_active = True
                threading.Thread(
                    target=self._flush_later, args=(instance,), daemon=True
                ).start()
        if run_now:
            self._run(instance, batch)
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def _drain(self) -> list[_Item]:
        """Caller must hold self._lock."""
        batch, self._pending = self._pending, []
        return batch

    def _flush_later(self, instance) -> None:
        while True:
            time.sleep(self._timeout)
            with self._lock:
                batch = self._drain()
                if not batch:
                    self._flusher_active = False
                    return
            self._run(instance, batch)
            with self._lock:
                if not self._pending:
                    self._flusher_active = False
                    return

    def _run(self, instance, batch: list[_Item]) -> None:
        values = [it.value for it in batch]
        n = len(values)
        if self._pad and n < self._max:
            bucket = _next_bucket(n, self._max)
            values = values + [values[-1]] * (bucket - n)
        try:
            if instance is not None:
                results = self._fn(instance, values)
            else:
                results = self._fn(values)
            results = list(results)[:n]
            if len(results) != n:
                raise ValueError(
                    f"Batched function returned {len(results)} results for a "
                    f"batch of {n}"
                )
            for it, r in zip(batch, results):
                it.result = r
                it.event.set()
        except Exception as e:
            for it in batch:
                it.error = e
                it.event.set()


def batch(
    _fn: Optional[Callable] = None,
    *,
    max_batch_size: int = 10,
    batch_wait_timeout_s: float = 0.01,
    pad_to_bucket: bool = False,
):
    """Decorator: turn `fn(self, items: list)` into a per-item callable whose
    concurrent invocations are batched. Use on replica methods."""

    def wrap(fn: Callable):
        queues: dict[int, _BatchQueue] = {}
        qlock = threading.Lock()

        def get_queue(key: int) -> _BatchQueue:
            with qlock:
                q = queues.get(key)
                if q is None:
                    q = _BatchQueue(
                        fn, max_batch_size, batch_wait_timeout_s, pad_to_bucket
                    )
                    queues[key] = q
                return q

        @functools.wraps(fn)
        def method_wrapper(self, value):
            return get_queue(id(self)).submit(self, value)

        @functools.wraps(fn)
        def fn_wrapper(value):
            return get_queue(0).submit(None, value)

        # Heuristic matching the reference: functions taking (self, batch)
        # get the method wrapper, (batch,) the plain one.
        import inspect

        params = list(inspect.signature(fn).parameters)
        if params and params[0] == "self":
            return method_wrapper
        return fn_wrapper

    if _fn is not None:
        return wrap(_fn)
    return wrap
