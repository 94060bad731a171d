"""ActorPool (reference: python/ray/util/actor_pool.py): distribute work over
a fixed set of actors, keeping each busy with at most one in-flight task."""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: Iterable[Any]):
        self._idle = list(actors)
        if not self._idle:
            raise ValueError("ActorPool requires at least one actor")
        self._future_to_actor: dict = {}
        self._index_to_future: dict = {}
        self._next_task_index = 0
        self._next_return_index = 0
        self._pending_submits: list = []

    # -- core ------------------------------------------------------------

    def submit(self, fn: Callable, value: Any) -> None:
        """fn(actor, value) -> ObjectRef. Queued if every actor is busy."""
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._future_to_actor[ref] = actor
            self._index_to_future[self._next_task_index] = ref
            self._next_task_index += 1
        else:
            self._pending_submits.append((fn, value))

    def get_next(self, timeout: Optional[float] = None) -> Any:
        """Next result in submission order. On timeout, pool state is
        unchanged (retryable); on task error the actor still returns to the
        pool before the exception propagates."""
        if not self.has_next():
            raise StopIteration("No more results")
        ref = self._index_to_future[self._next_return_index]
        if timeout is not None:
            ready, _ = ray_tpu_torch.wait([ref], num_returns=1, timeout=timeout)
            if not ready:
                raise TimeoutError("get_next timed out")
        del self._index_to_future[self._next_return_index]
        self._next_return_index += 1
        self._return_actor(self._future_to_actor.pop(ref))
        return ray_tpu_torch.get(ref)

    def get_next_unordered(self, timeout: Optional[float] = None) -> Any:
        """Next result in completion order."""
        if not self.has_next():
            raise StopIteration("No more results")
        ready, _ = ray_tpu_torch.wait(
            list(self._future_to_actor), num_returns=1, timeout=timeout
        )
        if not ready:
            raise TimeoutError("get_next_unordered timed out")
        ref = ready[0]
        for idx, fut in list(self._index_to_future.items()):
            if fut == ref:
                del self._index_to_future[idx]
                break
        self._return_actor(self._future_to_actor.pop(ref))
        return ray_tpu_torch.get(ref)

    def has_next(self) -> bool:
        return bool(self._future_to_actor) or bool(self._pending_submits)

    def _return_actor(self, actor) -> None:
        self._idle.append(actor)
        if self._pending_submits:
            fn, value = self._pending_submits.pop(0)
            self.submit(fn, value)

    # -- sugar -------------------------------------------------------------

    def map(self, fn: Callable, values: Iterable[Any]) -> Iterable[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable[Any]) -> Iterable[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def has_free(self) -> bool:
        return bool(self._idle)

    def pop_idle(self) -> Optional[Any]:
        return self._idle.pop() if self._idle else None

    def push(self, actor: Any) -> None:
        self._idle.append(actor)
