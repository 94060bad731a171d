"""The port's streaming generators and core utilities: ActorPool, Queue,
multiprocessing Pool and ParallelIterator (ray_tpu_torch.util).

Every case of tests/test_streaming_util.py on ray_tpu_torch (reference test
models: python/ray/tests/test_streaming_generator.py, test_actor_pool.py,
test_queue.py, util/multiprocessing tests), then parity with the reference
(ActorPool.map's order, Pool's results and ParallelIterator's outputs on the
same seeded inputs) and the two check_serialize cases of
tests/test_runtime_env.py.
"""

import time

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util.multiprocessing import Pool
from ray_tpu_torch.util.queue import Empty, Full, Queue

T = 60.0  # every get/wait in this file has its own timeout


@pytest.fixture(scope="module")
def rt():
    runtime = ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield runtime
    ray_tpu_torch.shutdown()


# ---------------- streaming generators ----------------


def test_streaming_generator_basic(rt):
    @ray_tpu_torch.remote(num_returns="streaming")
    def gen(n):
        for i in range(n):
            yield i * 10

    out = [ray_tpu_torch.get(ref, timeout=T) for ref in gen.remote(5)]
    assert out == [0, 10, 20, 30, 40]


def test_streaming_generator_incremental(rt):
    """Consumer sees early items while the producer is still running."""

    @ray_tpu_torch.remote(num_returns="streaming")
    def slow_gen():
        for i in range(3):
            yield i
            time.sleep(0.3)

    start = time.monotonic()
    it = iter(gen_obj := slow_gen.remote())
    first = ray_tpu_torch.get(next(it), timeout=T)
    first_latency = time.monotonic() - start
    assert first == 0
    # Got item 0 well before the full ~0.9s run completes.
    assert first_latency < 0.6
    rest = [ray_tpu_torch.get(r, timeout=T) for r in it]
    assert rest == [1, 2]


def test_streaming_generator_error_mid_stream(rt):
    @ray_tpu_torch.remote(num_returns="streaming")
    def bad_gen():
        yield 1
        yield 2
        raise RuntimeError("boom")

    refs = list(bad_gen.remote())
    assert ray_tpu_torch.get(refs[0], timeout=T) == 1
    assert ray_tpu_torch.get(refs[1], timeout=T) == 2
    with pytest.raises(Exception, match="boom"):
        ray_tpu_torch.get(refs[2], timeout=T)


def test_streaming_generator_on_actor(rt):
    @ray_tpu_torch.remote
    class Gen:
        @ray_tpu_torch.method(num_returns="streaming")
        def produce(self, n):
            for i in range(n):
                yield i + 100

    g = Gen.remote()
    out = [ray_tpu_torch.get(r, timeout=T) for r in g.produce.remote(3)]
    assert out == [100, 101, 102]


def test_streaming_generator_empty(rt):
    @ray_tpu_torch.remote(num_returns="streaming")
    def empty():
        if False:
            yield 1

    assert list(empty.remote()) == []


# ---------------- ActorPool ----------------


def test_actor_pool_map_ordered(rt):
    @ray_tpu_torch.remote
    class Worker:
        def double(self, x):
            return 2 * x

    pool = ActorPool([Worker.remote() for _ in range(2)])
    out = list(pool.map(lambda a, v: a.double.remote(v), range(8)))
    assert out == [0, 2, 4, 6, 8, 10, 12, 14]


def test_actor_pool_map_unordered(rt):
    @ray_tpu_torch.remote
    class Worker:
        def work(self, x):
            time.sleep(0.01 * (x % 3))
            return x

    pool = ActorPool([Worker.remote() for _ in range(3)])
    out = list(pool.map_unordered(lambda a, v: a.work.remote(v), range(9)))
    assert sorted(out) == list(range(9))


def test_actor_pool_submit_get_next(rt):
    @ray_tpu_torch.remote
    class Worker:
        def echo(self, x):
            return x

    pool = ActorPool([Worker.remote()])
    pool.submit(lambda a, v: a.echo.remote(v), "a")
    pool.submit(lambda a, v: a.echo.remote(v), "b")
    assert pool.get_next(timeout=T) == "a"
    assert pool.get_next(timeout=T) == "b"
    assert not pool.has_next()


# ---------------- Queue ----------------


def test_queue_fifo(rt):
    q = Queue()
    for i in range(5):
        q.put(i)
    assert q.qsize() == 5
    assert [q.get(timeout=T) for _ in range(5)] == [0, 1, 2, 3, 4]
    assert q.empty()


def test_queue_maxsize_and_timeouts(rt):
    q = Queue(maxsize=2)
    q.put(1)
    q.put(2)
    assert q.full()
    with pytest.raises(Full):
        q.put(3, block=False)
    with pytest.raises(Full):
        q.put(3, timeout=0.1)
    assert q.get(timeout=T) == 1
    q.put(3)
    with pytest.raises(Empty):
        Queue().get(timeout=0.1)


def test_queue_batch_ops(rt):
    q = Queue()
    q.put_nowait_batch([1, 2, 3])
    assert q.get_nowait_batch(2) == [1, 2]
    with pytest.raises(Empty):
        q.get_nowait_batch(5)


def test_queue_producer_consumer_threads(rt):
    import threading

    q = Queue(maxsize=4)
    results = []

    def producer():
        for i in range(20):
            q.put(i)

    def consumer():
        for _ in range(20):
            results.append(q.get(timeout=10))

    tp = threading.Thread(target=producer)
    tc = threading.Thread(target=consumer)
    tp.start(); tc.start()
    tp.join(timeout=30); tc.join(timeout=30)
    assert results == list(range(20))


# ---------------- multiprocessing Pool ----------------


def _square(x):
    return x * x


def test_pool_map(rt):
    with Pool(2) as pool:
        assert pool.map(_square, range(6)) == [0, 1, 4, 9, 16, 25]


def test_pool_apply_and_async(rt):
    with Pool(2) as pool:
        assert pool.apply(_square, (3,)) == 9
        res = pool.apply_async(_square, (4,))
        assert res.get(timeout=10) == 16


def test_pool_starmap_imap(rt):
    def add(a, b):
        return a + b

    with Pool(2) as pool:
        assert pool.starmap(add, [(1, 2), (3, 4)]) == [3, 7]
        assert list(pool.imap(_square, range(4), chunksize=2)) == [0, 1, 4, 9]
        assert sorted(pool.imap_unordered(_square, range(4), chunksize=1)) == [
            0,
            1,
            4,
            9,
        ]


def test_streaming_generator_on_async_actor(rt):
    """Regression: streaming methods on async actors must drive the generator."""

    @ray_tpu_torch.remote
    class AsyncGen:
        async def ping(self):
            return "pong"

        @ray_tpu_torch.method(num_returns="streaming")
        async def produce(self, n):
            for i in range(n):
                yield i * 2

        @ray_tpu_torch.method(num_returns="streaming")
        def produce_sync(self, n):
            for i in range(n):
                yield i + 1

    a = AsyncGen.remote()
    assert ray_tpu_torch.get(a.ping.remote(), timeout=T) == "pong"
    assert [ray_tpu_torch.get(r, timeout=T) for r in a.produce.remote(3)] == [0, 2, 4]
    assert [ray_tpu_torch.get(r, timeout=T) for r in a.produce_sync.remote(3)] == [1, 2, 3]


def test_actor_pool_timeout_is_retryable(rt):
    @ray_tpu_torch.remote
    class Slow:
        def work(self):
            time.sleep(0.5)
            return "done"

    pool = ActorPool([Slow.remote()])
    pool.submit(lambda a, v: a.work.remote(), None)
    with pytest.raises(TimeoutError):
        pool.get_next(timeout=0.05)
    # State unchanged: retry succeeds and the actor returns to the pool.
    assert pool.get_next(timeout=10) == "done"
    assert pool.has_free()


def test_actor_pool_task_error_returns_actor(rt):
    @ray_tpu_torch.remote
    class Flaky:
        def work(self, fail):
            if fail:
                raise ValueError("nope")
            return "ok"

    pool = ActorPool([Flaky.remote()])
    pool.submit(lambda a, v: a.work.remote(v), True)
    with pytest.raises(Exception, match="nope"):
        pool.get_next(timeout=T)
    pool.submit(lambda a, v: a.work.remote(v), False)
    assert pool.get_next(timeout=T) == "ok"


def test_streaming_generator_killed_actor_does_not_hang(rt):
    """Killing the actor while a streaming task is queued/running must finish
    the stream with ActorDiedError, not hang the reader (regression: every
    _finalize path now closes the stream)."""
    import time

    from ray_tpu_torch.exceptions import ActorDiedError

    @ray_tpu_torch.remote
    class Gen:
        def slow_stream(self):
            for i in range(100):
                time.sleep(0.05)
                yield i

    actor = Gen.options(max_restarts=0).remote()
    gen = actor.slow_stream.options(num_returns="streaming").remote()
    # Let the generator start, then kill mid-stream.
    time.sleep(0.2)
    ray_tpu_torch.kill(actor)
    with pytest.raises(ActorDiedError):
        for _ in range(200):
            ray_tpu_torch.get(next(gen), timeout=10.0)


# -- util.iter parallel iterators -----------------------------------------


def test_parallel_iterator_transforms(rt):
    from ray_tpu_torch.util import iter as par_iter

    it = (
        par_iter.from_range(20, num_shards=4)
        .for_each(lambda x: x * 2)
        .filter(lambda x: x % 4 == 0)
    )
    out = sorted(it.gather_sync())
    assert out == sorted(x * 2 for x in range(20) if (x * 2) % 4 == 0)


def test_parallel_iterator_batch_flatten(rt):
    from ray_tpu_torch.util import iter as par_iter

    batched = par_iter.from_items(list(range(10)), num_shards=2).batch(3)
    batches = list(batched.gather_sync())
    assert all(len(b) <= 3 for b in batches)
    flat = sorted(
        par_iter.from_items([[1, 2], [3], [4, 5]], num_shards=2)
        .flatten()
        .gather_sync()
    )
    assert flat == [1, 2, 3, 4, 5]


def test_parallel_iterator_async_and_take(rt):
    from ray_tpu_torch.util import iter as par_iter

    it = par_iter.from_range(100, num_shards=4).for_each(lambda x: x + 1)
    assert sorted(it.gather_async()) == list(range(1, 101))
    assert len(par_iter.from_range(50, num_shards=2).take(7)) == 7
    assert par_iter.from_range(13, num_shards=3).count() == 13


def test_parallel_iterator_from_iterators(rt):
    from ray_tpu_torch.util import iter as par_iter

    def make_gen(start):
        def gen():
            for i in range(3):
                yield start + i

        return gen

    it = par_iter.from_iterators([make_gen(0), make_gen(100)])
    assert sorted(it.gather_sync()) == [0, 1, 2, 100, 101, 102]


# -- parity with the reference ---------------------------------------------


def _util_program(pkg):
    """ActorPool.map / map_unordered, Pool.map / imap and ParallelIterator
    gather_sync / gather_async over the same seeded inputs, on `pkg`."""
    from importlib import import_module

    actor_pool = import_module(f"{pkg.__name__}.util.actor_pool")
    mp = import_module(f"{pkg.__name__}.util.multiprocessing")
    par_iter = import_module(f"{pkg.__name__}.util.iter")
    rng = np.random.RandomState(0)
    values = [rng.randn(3) for _ in range(12)]
    delays = rng.randint(0, 4, size=12) * 0.005

    @pkg.remote
    class Scaler:
        def __init__(self, k):
            self.k = k

        def scale(self, i, v):
            time.sleep(delays[i])  # finish out of submission order
            return i, v * self.k

    pool = actor_pool.ActorPool([Scaler.remote(2.0) for _ in range(3)])
    ordered = list(pool.map(lambda a, iv: a.scale.remote(*iv), enumerate(values)))
    unordered = sorted(pool.map_unordered(lambda a, iv: a.scale.remote(*iv),
                                          enumerate(values)), key=lambda r: r[0])
    with mp.Pool(2) as workers:
        pooled = workers.map(np.linalg.norm, values)
        imapped = list(workers.imap(np.sum, values, chunksize=5))
    items = [float(x) for x in rng.randn(20)]
    it = par_iter.from_items(items, num_shards=3).for_each(lambda x: round(x * 3, 6))
    synced = list(it.filter(lambda x: x > -1.0).gather_sync(batch_ahead=2))
    asynced = sorted(it.batch(4).flatten().gather_async())
    return ordered, unordered, pooled, imapped, synced, asynced


def test_utilities_match_the_reference(rt):
    """ActorPool.map returns in submission order and map_unordered every
    result; Pool and ParallelIterator give the reference's outputs (the
    synchronous gather in the same round-robin order), on the same inputs."""
    ray_tpu.init(num_cpus=4)
    try:
        want = _util_program(ray_tpu)
    finally:
        ray_tpu.shutdown()
    got = _util_program(ray_tpu_torch)
    ordered, unordered = got[0], got[1]
    assert [i for i, _ in ordered] == list(range(12))
    for part_got, part_want in zip(got, want):
        assert len(part_got) == len(part_want)
        for g, w in zip(part_got, part_want):
            if isinstance(g, tuple):
                assert g[0] == w[0]
                np.testing.assert_array_equal(g[1], w[1])
            else:
                np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.stack([v for _, v in ordered]),
                                  np.stack([v for _, v in unordered]))


# -- check_serialize (tests/test_runtime_env.py :105, :149) ------------------


def test_inspect_serializability_finds_culprit():
    import threading

    from ray_tpu_torch.util import inspect_serializability

    lock = threading.Lock()

    def closure_over_lock():
        return lock

    ok, failures = inspect_serializability(closure_over_lock)
    assert not ok
    assert any(f.name == "lock" for f in failures)

    ok, failures = inspect_serializability(lambda: 1)
    assert ok and not failures


def test_nested_parent_attribution():
    import threading

    from ray_tpu_torch.util.check_serialize import inspect_serializability

    class Client:
        def __init__(self):
            self._sock = threading.Lock()

    class Holder:
        def __init__(self):
            self.client = Client()

    ok, failures = inspect_serializability(Holder(), name="holder")
    assert not ok
    culprit = next(f for f in failures if f.name == "_sock")
    assert culprit.parent == "client"
