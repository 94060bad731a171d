"""ray_tpu_torch.data against ray_tpu.data.

The first 48 tests are tests/test_data.py's, run on the port (its runtime,
its Dataset; device batches on device="cpu"). The rest run the same seeded
pipeline through both packages, each on its own runtime, and hold the port's
rows, batches and aggregates to the reference's: exactly equal, except Mean
and Std, which are held to a relative 1e-12 (both fold the same Python
floats, so in practice they agree exactly too).
"""

import os
import threading

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.data as jd
import ray_tpu_torch
from ray_tpu_torch import data as rd

torch.set_num_threads(1)

AGG_RTOL = 1e-12  # Mean and Std; every other aggregate is exact


@pytest.fixture
def rt():
    runtime = ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield runtime
    ray_tpu_torch.shutdown()


def test_range_count_take(rt):
    ds = rd.range(100)
    assert ds.count() == 100
    assert ds.take(3) == [{"id": 0}, {"id": 1}, {"id": 2}]


def test_map_batches_numpy(rt):
    ds = rd.range(64).map_batches(lambda b: {"x": b["id"] * 2})
    got = ds.take_all()
    assert got[5] == {"x": 10}


def test_map_filter_flatmap_chain(rt):
    ds = (
        rd.range(20)
        .map(lambda r: {"v": r["id"] + 1})
        .filter(lambda r: r["v"] % 2 == 0)
        .flat_map(lambda r: [r, r])
    )
    rows = ds.take_all()
    assert len(rows) == 20
    assert all(r["v"] % 2 == 0 for r in rows)


def test_limit_and_schema(rt):
    ds = rd.range(1000).limit(17)
    assert ds.count() == 17
    assert "id" in str(rd.range(4).schema())


def test_repartition(rt):
    ds = rd.range(100, parallelism=4).repartition(10)
    assert ds.materialize().num_blocks() == 10
    assert ds.count() == 100


def test_random_shuffle_preserves_rows(rt):
    ds = rd.range(50).random_shuffle(seed=7)
    got = sorted(r["id"] for r in ds.take_all())
    assert got == list(range(50))


def test_sort(rt):
    ds = rd.from_items([{"k": v} for v in [5, 3, 9, 1, 7, 2, 8]])
    out = [r["k"] for r in ds.sort("k").take_all()]
    assert out == sorted(out)
    out_d = [r["k"] for r in ds.sort("k", descending=True).take_all()]
    assert out_d == sorted(out_d, reverse=True)


def test_sort_distributed(rt):
    ds = rd.range(200, parallelism=8).map(lambda r: {"k": (r["id"] * 37) % 200})
    out = [r["k"] for r in ds.sort("k").take_all()]
    assert out == sorted(out)


def test_groupby_aggregate(rt):
    ds = rd.from_items(
        [{"g": i % 3, "v": i} for i in range(30)], parallelism=4
    )
    rows = ds.groupby("g").sum("v").take_all()
    by_g = {r["g"]: r["sum(v)"] for r in rows}
    assert by_g == {
        0: sum(i for i in range(30) if i % 3 == 0),
        1: sum(i for i in range(30) if i % 3 == 1),
        2: sum(i for i in range(30) if i % 3 == 2),
    }


def test_groupby_count_mean_std(rt):
    ds = rd.from_items([{"g": i % 2, "v": float(i)} for i in range(10)])
    got = ds.groupby("g").count().take_all()
    assert all(r["count()"] == 5 for r in got)
    means = {r["g"]: r["mean(v)"] for r in ds.groupby("g").mean("v").take_all()}
    assert means[0] == pytest.approx(4.0)
    assert means[1] == pytest.approx(5.0)


def test_global_aggregates(rt):
    ds = rd.from_items([{"v": i} for i in range(11)])
    assert ds.sum("v") == 55
    assert ds.min("v") == 0
    assert ds.max("v") == 10
    assert ds.mean("v") == 5.0


def test_map_groups(rt):
    ds = rd.from_items([{"g": i % 2, "v": i} for i in range(8)], parallelism=2)

    def normalize(batch):
        return [{"n": int(batch["v"].sum())}]

    rows = ds.groupby("g").map_groups(normalize).take_all()
    assert sorted(r["n"] for r in rows) == [12, 16]


def test_union_zip(rt):
    a = rd.range(5)
    b = rd.range(5).map(lambda r: {"id2": r["id"] * 10})
    assert a.union(rd.range(3)).count() == 8
    z = a.zip(b).take_all()
    assert z[2]["id"] == 2 and z[2]["id2"] == 20


def test_split(rt):
    shards = rd.range(100, parallelism=10).split(5)
    assert len(shards) == 5
    assert sum(s.count() for s in shards) == 100


def test_split_equal(rt):
    shards = rd.range(100, parallelism=3).split(4, equal=True)
    counts = [s.count() for s in shards]
    assert counts == [25, 25, 25, 25]


def test_split_equal_drops_remainder(rt):
    shards = rd.from_items([{"v": i} for i in range(11)]).split(3, equal=True)
    assert [s.count() for s in shards] == [3, 3, 3]


def test_groupby_single_block(rt):
    ds = rd.from_items([{"g": i % 2, "v": i} for i in range(6)], parallelism=1)
    rows = ds.groupby("g").sum("v").take_all()
    assert {r["g"]: r["sum(v)"] for r in rows} == {0: 6, 1: 9}
    assert rd.from_numpy(np.arange(5.0)).sum("data") == 10.0


def test_repartition_single_block(rt):
    ds = rd.from_items([{"id": i} for i in range(100)], parallelism=1)
    assert ds.repartition(1).count() == 100
    assert sorted(r["id"] for r in ds.repartition(1).take_all()) == list(
        range(100)
    )
    shuffled = ds.random_shuffle(seed=3)
    assert sorted(r["id"] for r in shuffled.take_all()) == list(range(100))


def test_repartition_shuffle_true(rt):
    ds = rd.range(100, parallelism=4).repartition(4, shuffle=True)
    got = [r["id"] for r in ds.take_all()]
    assert sorted(got) == list(range(100))
    assert got != list(range(100))


def test_streaming_split_multi_epoch(rt):
    its = rd.range(32, parallelism=4).streaming_split(2)
    for _epoch in range(3):
        a = sum(len(b["id"]) for b in its[0].iter_batches(batch_size=8))
        b = sum(len(b["id"]) for b in its[1].iter_batches(batch_size=8))
        assert a + b == 32


def test_zip_misaligned_blocks(rt):
    a = rd.range(10, parallelism=1)
    b = rd.range(10, parallelism=2).map(lambda r: {"id2": r["id"] * 10})
    rows = a.zip(b).take_all()
    assert len(rows) == 10
    assert all(r["id2"] == r["id"] * 10 for r in rows)


def test_zip_row_count_mismatch_raises(rt):
    with pytest.raises(ValueError):
        rd.range(10).zip(rd.range(7)).take_all()


def test_no_fusion_across_pool_sizes(rt):
    ds = (
        rd.range(16, parallelism=2)
        .map_batches(lambda b: {"x": b["id"]}, compute=1)
        .map_batches(lambda b: {"x": b["x"] + 1}, compute=2)
    )
    assert sorted(r["x"] for r in ds.take_all()) == list(range(1, 17))


def test_streaming_split(rt):
    its = rd.range(64, parallelism=8).streaming_split(2)
    a = list(its[0].iter_batches(batch_size=8, drop_last=False))
    b = list(its[1].iter_batches(batch_size=8, drop_last=False))
    rows = sum(len(x["id"]) for x in a) + sum(len(x["id"]) for x in b)
    assert rows == 64


def test_iter_batches_static_shapes(rt):
    """TPU contract: all batches exactly batch_size when drop_last."""
    batches = list(
        rd.range(100).iter_batches(batch_size=32, drop_last=True)
    )
    assert len(batches) == 3
    assert all(len(b["id"]) == 32 for b in batches)


def test_iter_batches_local_shuffle(rt):
    batches = list(
        rd.range(50).iter_batches(
            batch_size=10, local_shuffle_buffer_size=20, local_shuffle_seed=1
        )
    )
    flat = [int(v) for b in batches for v in b["id"]]
    assert sorted(flat) == list(range(50))
    assert flat != list(range(50))


def test_add_select_drop_rename_columns(rt):
    ds = rd.range(10).add_column("twice", lambda b: b["id"] * 2)
    row = ds.take(1)[0]
    assert row["twice"] == 0
    assert set(ds.select_columns(["twice"]).take(1)[0]) == {"twice"}
    assert set(ds.drop_columns(["twice"]).take(1)[0]) == {"id"}
    assert set(ds.rename_columns({"id": "idx"}).take(1)[0]) == {"idx", "twice"}


def test_from_numpy_pandas_arrow(rt):
    import pandas as pd
    import pyarrow as pa

    assert rd.from_numpy(np.ones((7, 2))).count() == 7
    df = pd.DataFrame({"a": [1, 2, 3]})
    assert rd.from_pandas(df).count() == 3
    t = pa.table({"a": [1, 2]})
    assert rd.from_arrow(t).take_all() == [{"a": 1}, {"a": 2}]


def test_parquet_roundtrip(rt, tmp_path):
    ds = rd.range(25)
    out = str(tmp_path / "pq")
    ds.write_parquet(out)
    back = rd.read_parquet(out)
    assert back.count() == 25
    assert sorted(r["id"] for r in back.take_all()) == list(range(25))


def test_csv_json_roundtrip(rt, tmp_path):
    ds = rd.from_items([{"a": i, "b": float(i)} for i in range(10)])
    csv_dir = str(tmp_path / "csv")
    ds.write_csv(csv_dir)
    assert rd.read_csv(csv_dir).count() == 10
    json_dir = str(tmp_path / "json")
    ds.write_json(json_dir)
    assert rd.read_json(json_dir).count() == 10


def test_read_text(rt, tmp_path):
    p = tmp_path / "f.txt"
    p.write_text("alpha\nbeta\n\ngamma\n")
    ds = rd.read_text(str(p))
    assert [r["text"] for r in ds.take_all()] == ["alpha", "beta", "gamma"]


def test_train_test_split(rt):
    train, test = rd.range(100).train_test_split(0.2)
    assert train.count() == 80
    assert test.count() == 20


def test_compute_actors(rt):
    ds = rd.range(32, parallelism=4).map_batches(
        lambda b: {"x": b["id"] + 1}, compute=2
    )
    assert sorted(r["x"] for r in ds.take_all()) == list(range(1, 33))


def test_range_tensor(rt):
    ds = rd.range_tensor(8, shape=(2, 2))
    batch = ds.take_batch(8)
    assert batch["data"].shape == (8, 2, 2)


def test_stats_populated(rt):
    ds = rd.range(32).map_batches(lambda b: b)
    ds.count()
    assert "MapBatches" in ds.stats()


def test_sum_mean_single_column_no_on(rt):
    import ray_tpu_torch.data as rd

    ds = rd.range(5)
    assert ds.sum() == 10
    assert ds.mean() == 2.0


def test_aggregate_multi_column_requires_on(rt):
    import pytest

    import ray_tpu_torch.data as rd

    ds = rd.from_items([{"a": 1, "b": 2}, {"a": 3, "b": 4}])
    assert ds.sum(on="a") == 4
    with pytest.raises(Exception, match="on"):
        ds.sum()


def test_split_at_indices_ref_level(rt):
    import ray_tpu_torch.data as rd

    ds = rd.range(10, parallelism=3)
    a, b, c = ds.split_at_indices([3, 7])
    assert [r["id"] for r in a.take_all()] == [0, 1, 2]
    assert [r["id"] for r in b.take_all()] == [3, 4, 5, 6]
    assert [r["id"] for r in c.take_all()] == [7, 8, 9]


def test_split_at_indices_out_of_range(rt):
    import ray_tpu_torch.data as rd

    ds = rd.range(4, parallelism=2)
    parts = ds.split_at_indices([2, 10])
    assert [len(p.take_all()) for p in parts] == [2, 2, 0]


def test_randomize_block_order_is_lazy_and_fresh_per_epoch(rt):
    import ray_tpu_torch.data as rd

    ds = rd.range(64, parallelism=16).randomize_block_order()
    orders = set()
    for _ in range(5):
        orders.add(tuple(r["id"] for r in ds.take_all()))
    # With 16 blocks, 5 independent permutations virtually never all collide.
    assert len(orders) > 1
    # Seeded: deterministic.
    ds2 = rd.range(64, parallelism=16).randomize_block_order(seed=7)
    assert [r["id"] for r in ds2.take_all()] == [r["id"] for r in ds2.take_all()]


def test_map_groups_scalar_dict_return(rt):
    import ray_tpu_torch.data as rd

    ds = rd.from_items([{"k": i % 2, "v": i} for i in range(6)])
    out = ds.groupby("k").map_groups(
        lambda g: {"k": int(g["k"][0]), "n": len(g["v"])}
    )
    rows = sorted(out.take_all(), key=lambda r: r["k"])
    assert rows == [{"k": 0, "n": 3}, {"k": 1, "n": 3}]


def test_streaming_split_many_blocks_shared_coordinator(rt):
    """Regression: per-rank coordinators deadlock once queues fill (>8 blocks)."""
    import ray_tpu_torch.data as rd

    ds = rd.range(200, parallelism=25)
    it0, it1 = ds.streaming_split(2)
    seen = []

    import threading

    def consume(it):
        local = [r["id"] for r in it.iter_rows()]
        seen.append(local)

    t0 = threading.Thread(target=consume, args=(it0,))
    t1 = threading.Thread(target=consume, args=(it1,))
    t0.start(); t1.start()
    t0.join(timeout=60); t1.join(timeout=60)
    assert not t0.is_alive() and not t1.is_alive(), "streaming_split deadlocked"
    assert sorted(seen[0] + seen[1]) == list(range(200))


def test_stats_every_operator_after_iter_batches(rt):
    """A map->filter->batch pipeline reports every operator with nonzero
    rows and wall time, and the stats populate through iter_batches
    consumption (the train-ingest path), not just materialization."""
    ds = (
        rd.range(64, parallelism=4)
        .map(lambda row: {"id": row["id"]})
        .filter(lambda row: row["id"] % 2 == 0)
        .map_batches(lambda b: {"id": b["id"] * 2}, batch_size=8)
    )
    batches = list(ds.iter_batches(batch_size=8, drop_last=False))
    assert sum(len(b["id"]) for b in batches) == 32

    stats = ds.stats_dict()
    report = ds.stats()
    for op in ("Map", "Filter", "MapBatches"):
        assert op in report, report
        stage = next(s for name, s in stats.items() if op in name)
        assert stage["rows"] > 0
        assert stage["wall_s"] > 0
        assert stage["task_wall_s"] and all(w > 0 for w in stage["task_wall_s"])
    assert "Slowest stage:" in report

    # Limit stages are tracked too (previously dark).
    limited = rd.range(64, parallelism=4).map(lambda r: r).limit(10)
    assert limited.count() == 10
    assert any("Limit" in name for name in limited.stats_dict())

    # Re-consumption re-runs the plan; stats reflect the latest epoch, not
    # an accumulation across epochs.
    list(ds.iter_batches(batch_size=8))
    stats2 = ds.stats_dict()
    stage2 = next(s for name, s in stats2.items() if "Filter" in name)
    assert stage2["rows"] == 32


def test_stats_per_operator_breakdown(rt):
    """ds.stats() reports blocks/rows/bytes and task wall-time distribution
    per operator (the reference's main input-pipeline perf tool)."""
    ds = (
        rd.range(600)
        .map_batches(lambda b: {"x": b["id"] * 2})
        .random_shuffle(seed=7)
    )
    ds.take_all()
    report = ds.stats()
    assert "Stage 1 Read->MapBatches" in report
    assert "Output rows: 600 total" in report
    assert "Output size bytes:" in report
    assert "task wall time:" in report and "mean" in report
    assert "RandomShuffle" in report


# -- TFRecords (native codec) -------------------------------------------------


def test_tfrecords_roundtrip(rt, tmp_path):
    """write_tfrecords -> read_tfrecords preserves int/float/bytes columns
    through the native (TF-free) record framing + Example wire format."""
    import numpy as np

    import ray_tpu_torch.data as rdata

    ds = rdata.from_items(
        [
            {"idx": i, "score": float(i) / 4.0, "tag": f"row-{i}".encode()}
            for i in range(40)
        ],
        parallelism=2,
    )
    out = str(tmp_path / "recs")
    files = ds.write_tfrecords(out)
    assert files and all(f.endswith(".tfrecords") for f in files)

    back = rdata.read_tfrecords(out).take_all()
    back.sort(key=lambda r: r["idx"])
    assert len(back) == 40
    assert back[7]["idx"] == 7
    assert abs(back[7]["score"] - 1.75) < 1e-6
    assert bytes(back[7]["tag"]) == b"row-7"


def test_tfrecords_crc_detects_corruption(tmp_path):
    from ray_tpu_torch.data.tfrecords import (
        encode_example,
        read_records,
        write_records,
    )

    path = str(tmp_path / "x.tfrecords")
    write_records(path, (encode_example({"v": i}) for i in range(5)))
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF  # flip a payload byte
    open(path, "wb").write(bytes(data))
    import pytest as _pytest

    with _pytest.raises(ValueError):
        list(read_records(path, verify=True))


def test_tfrecords_wire_format_shapes():
    """Multi-element lists survive; single-element lists squeeze."""
    from ray_tpu_torch.data.tfrecords import (
        decode_example,
        encode_example,
        examples_to_columns,
    )

    payload = encode_example(
        {"emb": [0.5, 1.5, 2.5], "label": 3, "name": b"abc"}
    )
    decoded = decode_example(payload)
    assert decoded["emb"] == [0.5, 1.5, 2.5]
    assert decoded["label"] == [3]
    assert decoded["name"] == [b"abc"]
    cols = examples_to_columns([decoded, decoded])
    assert cols["emb"].shape == (2, 3)
    assert cols["label"].tolist() == [3, 3]


def test_iter_device_batches_overlap(rt):
    """Device batches arrive as tensors with fixed shapes; the double
    buffer issues copy N+1 before yielding N."""
    import ray_tpu_torch.data as rdata

    ds = rdata.range_tensor(96, shape=(8,), parallelism=4)
    it = ds.iterator() if hasattr(ds, "iterator") else None
    source = it or ds
    device_batches = source.iter_device_batches(
        batch_size=32, drop_last=True, device="cpu"
    )
    batches = list(device_batches)
    assert len(batches) == 3
    for b in batches:
        assert isinstance(b["data"], torch.Tensor)
        assert b["data"].shape == (32, 8)
    total = sum(float(b["data"][:, 0].sum()) for b in batches)
    assert total == float(np.arange(96).sum())
    order = device_batches.order
    for n in range(2):
        assert order.index(("copy", n + 1)) < order.index(("yield", n))
    assert device_batches.copies_ahead == 2


# ---------------------------------------------------------------------------
# Parity: the same seeded pipeline through ray_tpu.data and ray_tpu_torch.data
# ---------------------------------------------------------------------------


@pytest.fixture
def both():
    """The reference's runtime and the port's, side by side."""
    ray_tpu.init(num_cpus=4)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _plain(x):
    """Rows, batches and blocks as plain Python values (numpy scalars and
    arrays become ints, floats and lists), so the two packages' outputs
    compare with ==."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (np.ndarray, np.generic)):
        return x.tolist()
    return x


def _assert_same(got, want, where="result"):
    """Exact equality, but Mean and Std values within AGG_RTOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (where, got, want)
        for k in want:
            if str(k).startswith(("mean(", "std(")) and want[k] is not None:
                assert got[k] == pytest.approx(want[k], rel=AGG_RTOL, abs=0), (where, k)
            else:
                _assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    else:
        assert got == want, (where, got, want)


def _rows(ds):
    return _plain(ds.take_all())


def _blocks(ds, d, core):
    """Each output block's rows, in block order (`d` the data package,
    `core` its runtime)."""
    return [
        _plain(list(d.BlockAccessor.for_block(core.get(ref)).iter_rows()))
        for ref, _meta in ds.iterator().materialize_refs()
    ]


def _squares(d, n=60, parallelism=4):
    return d.from_items(
        [{"g": i % 5, "v": float((i * i) % 17) - 4.5, "n": i} for i in range(n)],
        parallelism=parallelism,
    )


def _aggs(d):
    return (d.Count(), d.Sum("v"), d.Min("v"), d.Max("v"), d.AbsMax("v"),
            d.Mean("v"), d.Std("v"))


PIPELINES = {
    "range_map_batches_filter_flat_map": lambda d, core: _rows(
        d.range(64, parallelism=4)
        .map_batches(lambda b: {"x": b["id"] * 3}, batch_size=5)
        .filter(lambda r: r["x"] % 2 == 0)
        .flat_map(lambda r: [r, {"x": -r["x"]}])
        .map(lambda r: {"x": r["x"], "y": r["x"] + 1})
    ),
    "random_shuffle_seeded": lambda d, core: _rows(
        d.range(200, parallelism=8).random_shuffle(seed=11)
    ),
    "random_shuffle_seeded_blocks": lambda d, core: _blocks(
        d.range(90, parallelism=6).random_shuffle(seed=2), d, core
    ),
    "sort": lambda d, core: _rows(
        d.range(200, parallelism=8)
        .map(lambda r: {"k": (r["id"] * 37) % 101, "id": r["id"]})
        .sort("k")
    ),
    "sort_descending": lambda d, core: _rows(
        d.range(120, parallelism=5)
        .map(lambda r: {"k": (r["id"] * 13) % 29})
        .sort("k", descending=True)
    ),
    "repartition": lambda d, core: _blocks(
        d.range(100, parallelism=4).repartition(7), d, core
    ),
    "split": lambda d, core: [_rows(s) for s in d.range(100, parallelism=10).split(3)],
    "split_equal": lambda d, core: [
        _rows(s) for s in d.range(103, parallelism=3).split(4, equal=True)
    ],
    "split_at_indices": lambda d, core: [
        _rows(s) for s in d.range(100, parallelism=7).split_at_indices([13, 57, 58])
    ],
    "train_test_split": lambda d, core: [
        _rows(s)
        for s in d.range(100, parallelism=4).train_test_split(0.25, shuffle=True, seed=3)
    ],
    "local_shuffle_seeded": lambda d, core: _plain(list(
        d.range(100, parallelism=4).iter_batches(
            batch_size=10, local_shuffle_buffer_size=20, local_shuffle_seed=5,
            prefetch_batches=0)
    )),
    "iter_batches_drop_last": lambda d, core: _plain(list(
        d.range_tensor(100, shape=(3,), parallelism=6).iter_batches(
            batch_size=16, drop_last=True)
    )),
    "randomize_block_order_seeded": lambda d, core: _rows(
        d.range(64, parallelism=16).randomize_block_order(seed=7)
    ),
    "union": lambda d, core: _rows(
        d.range(5).union(d.range(3), d.range(4, parallelism=2).map(lambda r: {"id": -r["id"]}))
    ),
    "zip": lambda d, core: _rows(
        d.range(10, parallelism=1).zip(
            d.range(10, parallelism=3).map(lambda r: {"id2": r["id"] * 10}))
    ),
    "groupby_aggregate": lambda d, core: _rows(_squares(d).groupby("g").aggregate(*_aggs(d))),
    "groupby_sugar": lambda d, core: [
        _rows(getattr(_squares(d).groupby("g"), name)(*args))
        for name, args in (("count", ()), ("sum", ("v",)), ("min", ("v",)),
                           ("max", ("v",)), ("mean", ("v",)), ("std", ("v",)))
    ],
    "global_aggregates": lambda d, core: _plain(_squares(d).aggregate(*_aggs(d))),
    "global_sugar": lambda d, core: _plain([
        getattr(_squares(d), name)("v") for name in ("sum", "min", "max", "mean", "std")
    ]),
    "map_groups": lambda d, core: _rows(
        _squares(d).groupby("g").map_groups(
            lambda b: {"g": int(b["g"][0]), "total": float(b["v"].sum()), "n": len(b["v"])})
    ),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_pipeline_matches_reference(both, name):
    """The pipeline gives the same rows (or blocks, batches, aggregates)
    through both packages."""
    pipeline = PIPELINES[name]
    want = pipeline(jd, ray_tpu)
    got = pipeline(rd, ray_tpu_torch)
    _assert_same(got, want)


def _consume_split(iterators, epochs=1):
    """Each rank's ids, epoch by epoch, read on a thread of its own (a split
    feeds all ranks from one stream, so one rank alone could fill the
    others' queues and stall)."""
    seen = [[] for _ in iterators]

    def consume(rank, it):
        for _ in range(epochs):
            epoch = []
            for batch in it.iter_batches(batch_size=8, drop_last=False):
                epoch.extend(int(v) for v in batch["id"])
            seen[rank].append(epoch)

    threads = [threading.Thread(target=consume, args=(r, it)) for r, it in enumerate(iterators)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "streaming_split stalled"
    return seen


@pytest.mark.parametrize("equal", [False, True])
def test_streaming_split_matches_reference(both, equal):
    """streaming_split(2, equal=...) over uneven blocks: each rank reads the
    reference rank's ids, in its order, over two epochs; the ranks'
    ids are disjoint and together every row, each epoch."""
    want = _consume_split(jd.range(203, parallelism=25).streaming_split(2, equal=equal), 2)
    got = _consume_split(rd.range(203, parallelism=25).streaming_split(2, equal=equal), 2)
    assert got == want
    for epoch in range(2):
        ids = got[0][epoch] + got[1][epoch]
        assert sorted(ids) == list(range(203))
        assert not set(got[0][epoch]) & set(got[1][epoch])
