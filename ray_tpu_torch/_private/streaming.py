"""Streaming generator refs.

Reference: core_worker/task_manager.h ObjectRefStream (:100-151) +
_raylet.pyx:228 StreamingObjectRefGenerator: a generator task's items are
sealed as individual objects as they are yielded; the consumer iterates an
ObjectRefGenerator whose __next__ blocks until the producer reports the next
item (or the stream ends). Errors raised mid-generator are sealed into the
failing item's slot, so the consumer raises exactly at that point.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

_SENTINEL = object()


class ObjectRefStream:
    """Owner-side stream state: refs appear in yield order."""

    def __init__(self):
        self._cv = threading.Condition()
        self._items: deque = deque()
        self._done = False
        self._total: Optional[int] = None

    def offer(self, ref) -> None:
        with self._cv:
            self._items.append(ref)
            self._cv.notify_all()

    def finish(self, total: int) -> None:
        with self._cv:
            self._done = True
            self._total = total
            self._cv.notify_all()

    def next(self, timeout: Optional[float] = None):
        """Blocking pop; returns _SENTINEL when the stream is exhausted.
        timeout=None waits indefinitely (the producer task finishing always
        wakes us via finish())."""
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        with self._cv:
            while not self._items:
                if self._done:
                    return _SENTINEL
                if deadline is None:
                    self._cv.wait()
                else:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0 or not self._cv.wait(remaining):
                        raise TimeoutError("ObjectRefStream.next timed out")
            return self._items.popleft()


class ObjectRefGenerator:
    """Iterator of ObjectRefs over a producer task's yielded items
    (reference: StreamingObjectRefGenerator, _raylet.pyx:228)."""

    def __init__(self, stream: ObjectRefStream, task_id):
        self._stream = stream
        self._task_id = task_id

    def __iter__(self):
        return self

    def __next__(self):
        ref = self._stream.next()
        if ref is _SENTINEL:
            raise StopIteration
        return ref

    def __repr__(self):
        return f"ObjectRefGenerator({self._task_id.hex()[:12]})"
