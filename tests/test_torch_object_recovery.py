"""Lineage-based object recovery on the port (runtime.get_value /
_try_recover, the reference's object_recovery_manager.h:42): lost objects
are rebuilt by re-executing their producing task; explicit frees and put
objects never are. Every case of tests/test_object_recovery.py, then the
same recursive chain re-executes the same tasks the same number of times in
both packages."""

from __future__ import annotations

import os

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch.exceptions import ObjectFreedError, ObjectLostError


@pytest.fixture
def recovery_runtime():
    runtime = ray_tpu_torch.init(
        num_cpus=4,
        num_gpus=0,
        _system_config={
            # Small budget so spilling kicks in; spill dir on disk we can
            # sabotage; native store off to make loss paths deterministic.
            "object_store_memory": 4 * 1024 * 1024,
            "native_store_enabled": False,
        },
    )
    yield runtime
    ray_tpu_torch.shutdown()


class _MissingNative:
    def get_object(self, oid, track=True):
        return False, None

    def contains(self, oid):
        return False

    def pin(self, oid):
        return False

    def release(self, oid):
        pass

    def unpin_and_delete(self, oid):
        pass


def _simulate_shm_loss(runtime, oid):
    """Flip a sealed entry to 'bytes vanished from shm': get() raises
    ObjectLostError exactly as it would after shm LRU eviction."""
    entry = runtime.store._entries[oid]
    with runtime.store._lock:
        entry.value = None
        entry.in_native = True  # native lookup will miss (no native store)
    runtime.store._native = _MissingNative()


# --------------------------------------------- tests/test_object_recovery.py


def test_lost_object_is_recomputed(recovery_runtime, tmp_path):
    counter = tmp_path / "runs"
    counter.write_text("0")

    @ray_tpu_torch.remote
    def produce(path):
        n = int(open(path).read()) + 1
        open(path, "w").write(str(n))
        return {"n": n, "data": [1, 2, 3]}

    ref = produce.remote(str(counter))
    assert ray_tpu_torch.get(ref)["n"] == 1
    _simulate_shm_loss(recovery_runtime, ref.id)
    value = ray_tpu_torch.get(ref)
    assert value == {"n": 2, "data": [1, 2, 3]}  # re-executed
    assert counter.read_text() == "2"


def test_spill_file_deletion_recovers(recovery_runtime):
    @ray_tpu_torch.remote
    def big(i):
        return np.full(1_000_000, i, dtype=np.uint8)  # ~1MB each

    refs = [big.remote(i) for i in range(10)]  # ~10MB > 4MB budget -> spill
    ray_tpu_torch.get(refs[-1])
    store = recovery_runtime.store
    spilled = [
        (oid, e.spilled_uri)
        for oid, e in store._entries.items()
        if e.spilled_uri is not None
    ]
    assert spilled, "budget pressure should have spilled something"
    oid, uri = spilled[0]
    os.remove(uri)  # sabotage: the spill file vanishes out from under us
    idx = next(i for i, r in enumerate(refs) if r.id == oid)
    value = ray_tpu_torch.get(refs[idx])
    assert value[0] == idx and value.shape == (1_000_000,)


def test_recursive_chain_recovery(recovery_runtime, tmp_path):
    counter = tmp_path / "chain"
    counter.write_text("")

    @ray_tpu_torch.remote
    def first(path):
        open(path, "a").write("a")
        return 10

    @ray_tpu_torch.remote
    def second(x, path):
        open(path, "a").write("b")
        return x + 1

    a = first.remote(str(counter))
    b = second.remote(a, str(counter))
    assert ray_tpu_torch.get(b) == 11
    # Lose BOTH: recovering b must first re-run first() for its argument.
    _simulate_shm_loss(recovery_runtime, a.id)
    entry_b = recovery_runtime.store._entries[b.id]
    with recovery_runtime.store._lock:
        entry_b.value = None
        entry_b.in_native = True
    assert ray_tpu_torch.get(b) == 11
    assert "ab" in counter.read_text()[1:] or counter.read_text().count("a") >= 2


def test_freed_objects_are_not_recovered(recovery_runtime):
    @ray_tpu_torch.remote
    def produce():
        return 42

    ref = produce.remote()
    assert ray_tpu_torch.get(ref) == 42
    recovery_runtime.store.free([ref.id])
    with pytest.raises(ObjectFreedError):
        ray_tpu_torch.get(ref)


def test_put_objects_are_not_recoverable(recovery_runtime):
    ref = ray_tpu_torch.put([1, 2, 3])
    _simulate_shm_loss(recovery_runtime, ref.id)
    with pytest.raises(ObjectLostError):
        ray_tpu_torch.get(ref)


# ------------------------------------------------------- what the port adds


def _chain_recovery_counts(pkg, tmp_path) -> dict:
    """A three-step chain, then (1) the last value lost, (2) all three
    lost, (3) the middle one's spill file deleted: each loss read back,
    and the runs of each task counted from a log the tasks append to."""
    import importlib

    rt_mod = importlib.import_module(f"{pkg.__name__}._private.runtime")
    runtime = pkg.init(num_cpus=4, num_gpus=0, _system_config={
        "object_store_memory": 4 * 1024 * 1024, "native_store_enabled": False})
    log = tmp_path / f"{pkg.__name__}.log"
    log.write_text("")
    try:
        @pkg.remote
        def first(path):
            open(path, "a").write("a")
            return np.full(200_000, 1, dtype=np.float32)

        @pkg.remote
        def second(x, path):
            open(path, "a").write("b")
            return x + 1

        @pkg.remote
        def third(x, path):
            open(path, "a").write("c")
            return float(x.sum())

        a = first.remote(str(log))
        b = second.remote(a, str(log))
        c = third.remote(b, str(log))
        values = [pkg.get(c)]
        marks = [log.read_text()]
        store = rt_mod.get_runtime().store
        _simulate_shm_loss(runtime, c.id)
        values.append(pkg.get(c))
        marks.append(log.read_text())
        for ref in (a, b, c):
            _simulate_shm_loss(runtime, ref.id)
        values.append(pkg.get(c))
        marks.append(log.read_text())
        # Pressure: spill b, then lose its file.
        ballast = [pkg.put(np.zeros(300_000, dtype=np.float32)) for _ in range(4)]
        uri = store._entries[b.id].spilled_uri
        spilled = uri is not None
        if spilled:
            os.remove(uri)
        values.append(float(pkg.get(b).sum()))
        marks.append(log.read_text())
        del ballast
        return {"values": values, "runs": [{k: m.count(k) for k in "abc"} for m in marks],
                "spilled": spilled}
    finally:
        pkg.shutdown()


def test_chain_recovery_matches_the_reference(tmp_path):
    """The same chain, the same losses: the same tasks re-execute the same
    number of times, with the same values, in both packages."""
    import ray_tpu

    port = _chain_recovery_counts(ray_tpu_torch, tmp_path)
    ref = _chain_recovery_counts(ray_tpu, tmp_path)
    assert port == ref
    assert port["spilled"]
    assert port["runs"][:3] == [{"a": 1, "b": 1, "c": 1}, {"a": 1, "b": 1, "c": 2},
                                {"a": 2, "b": 2, "c": 3}]
