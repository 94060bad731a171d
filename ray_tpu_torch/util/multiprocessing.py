"""multiprocessing.Pool API on actors (reference: python/ray/util/
multiprocessing/pool.py — Pool of actor workers with map/apply surfaces)."""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch
from ray_tpu_torch.util.actor_pool import ActorPool


class _PoolWorker:
    def __init__(self, initializer=None, initargs=()):
        if initializer:
            initializer(*initargs)

    def run(self, fn, args, kwargs):
        return fn(*args, **kwargs)

    def run_batch(self, fn, chunk):
        return [fn(item) for item in chunk]

    def run_starbatch(self, fn, chunk):
        return [fn(*item) for item in chunk]


class AsyncResult:
    def __init__(self, refs: List[Any], single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        values = ray_tpu_torch.get(self._refs, timeout=timeout)
        if self._single:
            return values[0]
        return list(itertools.chain.from_iterable(values))

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        ready, _ = ray_tpu_torch.wait(
            self._refs, num_returns=len(self._refs), timeout=0
        )
        return len(ready) == len(self._refs)

    def successful(self) -> bool:
        try:
            self.get(timeout=0)
            return True
        except Exception:
            return False


class Pool:
    """Process-pool lookalike; workers are actors, so the pool spans the
    cluster when nodes exist (reference: util/multiprocessing)."""

    def __init__(
        self,
        processes: Optional[int] = None,
        initializer: Optional[Callable] = None,
        initargs: tuple = (),
        ray_remote_args: Optional[dict] = None,
    ):
        if processes is None:
            total = ray_tpu_torch.cluster_resources().get("CPU", 1)
            processes = max(1, int(total))
        self._processes = processes
        opts = dict(ray_remote_args or {})
        worker_cls = ray_tpu_torch.remote(_PoolWorker)
        if opts:
            worker_cls = worker_cls.options(**opts)
        self._actors = [
            worker_cls.remote(initializer, initargs) for _ in range(processes)
        ]
        self._rr = itertools.count()
        self._closed = False

    def _chunks(self, iterable: Iterable, chunksize: Optional[int]):
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        for i in range(0, len(items), chunksize):
            yield items[i : i + chunksize]

    def _check_running(self):
        if self._closed:
            raise ValueError("Pool not running")

    # -- apply ------------------------------------------------------------

    def apply(self, fn: Callable, args: tuple = (), kwds: Optional[dict] = None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(
        self, fn: Callable, args: tuple = (), kwds: Optional[dict] = None
    ) -> AsyncResult:
        self._check_running()
        # Round-robin so concurrent applies use the whole pool.
        actor = self._actors[next(self._rr) % len(self._actors)]
        ref = actor.run.remote(fn, args, kwds or {})
        return AsyncResult([ref], single=True)

    # -- map --------------------------------------------------------------

    def map(
        self, fn: Callable, iterable: Iterable, chunksize: Optional[int] = None
    ) -> List[Any]:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(
        self, fn: Callable, iterable: Iterable, chunksize: Optional[int] = None
    ) -> AsyncResult:
        self._check_running()
        refs = []
        for i, chunk in enumerate(self._chunks(iterable, chunksize)):
            actor = self._actors[i % len(self._actors)]
            refs.append(actor.run_batch.remote(fn, chunk))
        return AsyncResult(refs, single=False)

    def starmap(
        self, fn: Callable, iterable: Iterable, chunksize: Optional[int] = None
    ) -> List[Any]:
        self._check_running()
        refs = []
        for i, chunk in enumerate(self._chunks(iterable, chunksize)):
            actor = self._actors[i % len(self._actors)]
            refs.append(actor.run_starbatch.remote(fn, chunk))
        return AsyncResult(refs, single=False).get()

    def imap(
        self, fn: Callable, iterable: Iterable, chunksize: Optional[int] = None
    ):
        self._check_running()
        pool = ActorPool(self._actors)
        chunks = list(self._chunks(iterable, chunksize))
        yield from itertools.chain.from_iterable(
            pool.map(lambda a, c: a.run_batch.remote(fn, c), chunks)
        )

    def imap_unordered(
        self, fn: Callable, iterable: Iterable, chunksize: Optional[int] = None
    ):
        self._check_running()
        pool = ActorPool(self._actors)
        chunks = list(self._chunks(iterable, chunksize))
        yield from itertools.chain.from_iterable(
            pool.map_unordered(lambda a, c: a.run_batch.remote(fn, c), chunks)
        )

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True
        for a in self._actors:
            ray_tpu_torch.kill(a)

    def join(self) -> None:
        if not self._closed:
            raise ValueError("Pool is still running")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
        return False
