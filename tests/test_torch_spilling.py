"""Object spilling on the port (ray_tpu_torch/_private/external_storage.py
behind object_store.InProcessStore): every case of tests/test_spilling.py,
then the same seeded puts under the same budget spill the same objects, with
the same stats(), in both packages."""

import os

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch._private.external_storage import FileSystemStorage
from ray_tpu_torch._private.ids import JobID, ObjectID, TaskID
from ray_tpu_torch._private.object_store import InProcessStore, OutOfMemoryError

_TASK = TaskID.for_job(JobID.from_int(1))


def _oid(i: int) -> ObjectID:
    return ObjectID.of(_TASK, i + 1)


# ---------------------------------------------------- tests/test_spilling.py


def test_spill_and_restore_roundtrip(tmp_path):
    storage = FileSystemStorage(str(tmp_path))
    store = InProcessStore(memory_budget=1_000_000, spill_storage=storage)
    # Everything pinned (default pinned_check is always-pinned).
    values = {}
    for i in range(5):
        arr = np.full(100_000, i, dtype=np.float32)  # 400KB each
        values[i] = arr
        store.seal(_oid(i), arr)
    assert storage.stats()["num_spilled"] > 0
    assert store.used_bytes <= 1_000_000
    for i in range(5):
        np.testing.assert_array_equal(store.get(_oid(i)), values[i])
    storage.destroy()


def test_oom_when_spilling_disabled():
    store = InProcessStore(memory_budget=500_000, spill_storage=None)
    store.seal(_oid(0), np.zeros(100_000, dtype=np.float32))
    with pytest.raises(OutOfMemoryError):
        store.seal(_oid(1), np.zeros(200_000, dtype=np.float32))


def test_delete_removes_spill_files(tmp_path):
    storage = FileSystemStorage(str(tmp_path))
    store = InProcessStore(memory_budget=500_000, spill_storage=storage)
    for i in range(4):
        store.seal(_oid(i), np.zeros(100_000, dtype=np.float32))
    spilled_files = os.listdir(storage.directory)
    assert spilled_files
    store.delete([_oid(i) for i in range(4)])
    assert not os.listdir(storage.directory)
    storage.destroy()


def test_end_to_end_spill_under_pressure():
    rt = ray_tpu_torch.init(
        num_cpus=2,
        num_gpus=0,
        _system_config={
            "object_store_memory": 3_000_000,
            "native_store_enabled": False,
        },
    )
    try:
        refs = [
            ray_tpu_torch.put(np.full(250_000, i, dtype=np.float32)) for i in range(8)
        ]
        for i, ref in enumerate(refs):
            assert ray_tpu_torch.get(ref)[0] == i
        stats = rt._spill_storage.stats()
        assert stats["num_spilled"] > 0
        assert rt.store.used_bytes <= 3_000_000
        spill_dir = rt._spill_storage.directory
    finally:
        ray_tpu_torch.shutdown()
    assert not os.path.exists(spill_dir)  # the runtime's own directory goes


def test_evicting_skips_spilled_entries(tmp_path):
    """Spilled entries hold no resident bytes: mem eviction must not
    double-subtract their size or orphan their files (regression)."""
    storage = FileSystemStorage(str(tmp_path))
    store = InProcessStore(memory_budget=1_000_000, spill_storage=storage)
    store.set_pinned_check(lambda oid: True)  # everything pinned -> spills
    for i in range(3):
        store.seal(_oid(i), np.zeros(100_000, dtype=np.float32))
    # Unpin everything; new pressure must evict resident entries only.
    store.set_pinned_check(lambda oid: False)
    for i in range(3, 7):
        store.seal(_oid(i), np.zeros(100_000, dtype=np.float32))
    assert store.used_bytes >= 0
    # Spilled objects still restorable.
    for i in range(3):
        if store.contains(_oid(i)):
            assert store.get(_oid(i)).nbytes == 400_000
    storage.destroy()


def test_user_spill_dir_not_wiped(tmp_path):
    keep = tmp_path / "keep.txt"
    keep.write_text("precious")
    storage = FileSystemStorage(str(tmp_path))
    uri = storage.spill(_oid(0), b"data")
    storage.destroy()
    assert keep.exists()  # user files survive
    assert not os.path.exists(uri)  # ours removed


# ------------------------------------------------------- what the port adds


def _spill_run(pkg: str, tmp_path, seed: int) -> dict:
    """Seeded puts of mixed sizes and kinds under one budget, half of them
    released as they go: which ids spilled, the store's use, stats(), and
    every value read back."""
    if pkg == "ray_tpu":
        from ray_tpu._private.external_storage import FileSystemStorage as Storage
        from ray_tpu._private.ids import JobID as J, ObjectID as O, TaskID as T
        from ray_tpu._private.object_store import InProcessStore as Store
    else:
        Storage, J, O, T, Store = FileSystemStorage, JobID, ObjectID, TaskID, InProcessStore
    task = T.for_job(J.from_int(1))
    storage = Storage(str(tmp_path / pkg))
    store = Store(memory_budget=2_000_000, spill_storage=storage)
    released: set = set()
    store.set_pinned_check(lambda oid: oid not in released)
    rng = np.random.RandomState(seed)
    values = {}
    for i in range(40):
        oid = O.of(task, i + 1)
        n = int(rng.randint(1_000, 120_000))
        kind = rng.randint(3)
        value = (np.full(n, i, dtype=np.float32) if kind == 0
                 else {"i": i, "pad": bytes(n)} if kind == 1 else list(range(n // 50)))
        store.seal(oid, value)
        values[i] = value
        if rng.rand() < 0.3:
            released.add(oid)
    spilled = sorted(int(oid.hex()[-8:], 16) for oid, e in store._entries.items()
                     if e.spilled_uri is not None)
    out = {"spilled": spilled, "used": store.used_bytes, "stats": None,
           "contains": [store.contains(O.of(task, i + 1)) for i in range(40)]}
    for i in range(40):
        oid = O.of(task, i + 1)
        if store.contains(oid):
            got = store.get(oid)
            if isinstance(got, np.ndarray):
                np.testing.assert_array_equal(got, values[i])
            else:
                assert got == values[i]
    out["stats"] = storage.stats()
    storage.destroy()
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_spill_decisions_match_the_reference(tmp_path, seed):
    """The same seeded puts under the same budget, with the same objects
    released: the same ids evicted, the same ids spilled, the same bytes in
    memory and the same stats(). A spill file names the store's _Pickled
    class by its module, whose path is len("_torch") bytes longer in the
    port: that is the whole difference in bytes."""
    port = _spill_run("ray_tpu_torch", tmp_path, seed)
    ref = _spill_run("ray_tpu", tmp_path, seed)
    assert len(port["spilled"]) >= 3, "the budget never forced spills"
    longer = len("_torch")
    for key, count in (("spilled_bytes", "num_spilled"), ("restored_bytes", "num_restored")):
        port["stats"][key] -= longer * port["stats"][count]
    assert port == ref


def test_reseal_keeps_the_first_shm_value(tmp_path):
    """A reseal of an id whose first value is in the native store (a retried
    task's second return) keeps that value readable: the store drops only
    the pin the second put took. The reference's seal deletes the first
    value there (ROADMAP.md §D26), so its next read finds it gone."""
    from ray_tpu_torch._private.native_store import NativeStore

    native = NativeStore(f"/tpt_reseal_{os.getpid()}", capacity=8 << 20)
    try:
        store = InProcessStore(memory_budget=None, native=native,
                               native_threshold=64 * 1024)
        first = np.arange(100_000, dtype=np.float32)
        store.seal(_oid(0), first)
        store.seal(_oid(0), first + 1)  # the retry's value: dropped
        assert store.is_native(_oid(0))
        np.testing.assert_array_equal(store.get(_oid(0)), first)
        store.delete([_oid(0)])
        assert not native.contains(_oid(0))  # the owner's one pin released
    finally:
        native.destroy()
