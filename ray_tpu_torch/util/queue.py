"""Distributed FIFO queue backed by an actor (reference:
python/ray/util/queue.py — Queue wraps an asyncio.Queue inside an actor)."""

from __future__ import annotations

import time
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        from collections import deque

        self._maxsize = maxsize
        self._items: deque = deque()

    def qsize(self) -> int:
        return len(self._items)

    def empty(self) -> bool:
        return not self._items

    def full(self) -> bool:
        return self._maxsize > 0 and len(self._items) >= self._maxsize

    def put_nowait(self, item: Any) -> bool:
        if self.full():
            return False
        self._items.append(item)
        return True

    def put_nowait_batch(self, items: List[Any]) -> bool:
        if self._maxsize > 0 and len(self._items) + len(items) > self._maxsize:
            return False
        self._items.extend(items)
        return True

    def get_nowait(self):
        if not self._items:
            return False, None
        return True, self._items.popleft()

    def get_nowait_batch(self, num_items: int):
        if len(self._items) < num_items:
            return False, None
        return True, [self._items.popleft() for _ in range(num_items)]


class Queue:
    """Client handle; blocking semantics are implemented caller-side by
    polling the queue actor (the in-process runtime makes this cheap)."""

    POLL_S = 0.005

    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        opts = dict(actor_options or {})
        self.maxsize = maxsize
        self.actor = (
            ray_tpu_torch.remote(_QueueActor).options(**opts).remote(maxsize)
            if opts
            else ray_tpu_torch.remote(_QueueActor).remote(maxsize)
        )

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return ray_tpu_torch.get(self.actor.empty.remote())

    def full(self) -> bool:
        return ray_tpu_torch.get(self.actor.full.remote())

    def put(
        self, item: Any, block: bool = True, timeout: Optional[float] = None
    ) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                return
            if not block:
                raise Full
            if deadline is not None and time.monotonic() >= deadline:
                raise Full
            time.sleep(self.POLL_S)

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        if not ray_tpu_torch.get(self.actor.put_nowait_batch.remote(list(items))):
            raise Full

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, item = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if ok:
                return item
            if not block:
                raise Empty
            if deadline is not None and time.monotonic() >= deadline:
                raise Empty
            time.sleep(self.POLL_S)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        ok, items = ray_tpu_torch.get(self.actor.get_nowait_batch.remote(num_items))
        if not ok:
            raise Empty
        return items

    def shutdown(self) -> None:
        ray_tpu_torch.kill(self.actor)
