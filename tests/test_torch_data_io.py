"""ray_tpu_torch.data's files and device batches.

Files: parquet, csv, json, numpy and TFRecord files written by one package
are read by the other, and give the rows that the writer's own package reads
back; text and binary reads of those files agree too. TFRecord files of the
same rows are byte-identical, and either package's CRC check catches a
flipped byte in the other's file.

Device batches: the numpy path runs with pandas and pyarrow blocked (the
card's machine has neither); `iter_device_batches` raises without CUDA
unless asked for the CPU, refuses object and string columns by name, and an
abandoned prefetching iterator's producer thread ends. The pinned-memory,
copy-stream path is held on the card by the `cuda` case (the reference is
imported inside the tests that need it, so that case also runs where JAX is
absent: `python -m pytest --noconftest -q tests/test_torch_data_io.py -k card`).
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import data as rd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


@pytest.fixture
def rt():
    runtime = ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield runtime
    ray_tpu_torch.shutdown()


@pytest.fixture
def both():
    """Both runtimes up; yields {"reference": ray_tpu.data, "port": ...}."""
    import ray_tpu
    import ray_tpu.data as jd

    ray_tpu.init(num_cpus=4)
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield {"reference": jd, "port": rd}
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, (np.ndarray, np.generic)):
        return x.tolist()
    return x


ITEMS = [{"idx": i, "score": i / 4.0, "name": f"row-{i}"} for i in range(30)]
TF_ITEMS = [
    {"idx": i, "score": i / 4.0, "tag": f"row-{i}".encode(), "emb": [i / 2.0, -i / 8.0]}
    for i in range(30)
]


def _write(d, fmt, path):
    """Write a three-block dataset of `fmt` with package `d`."""
    if fmt == "numpy":
        ds = d.from_numpy([np.arange(12.0).reshape(4, 3) + k for k in range(3)])
        return ds.write_numpy(path, column="data")
    if fmt == "tfrecords":
        return d.from_items(TF_ITEMS, parallelism=3).write_tfrecords(path)
    return getattr(d.from_items(ITEMS, parallelism=3), f"write_{fmt}")(path)


def _read(d, fmt, path):
    rows = _plain(getattr(d, f"read_{fmt}")(path).take_all())
    if fmt == "numpy":
        return rows
    return sorted(rows, key=lambda r: r["idx"])


@pytest.mark.parametrize("fmt", ["parquet", "csv", "json", "numpy", "tfrecords"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_file_written_by_one_package_is_read_by_the_other(both, tmp_path, fmt, writer):
    w = both[writer]
    r = both["port" if writer == "reference" else "reference"]
    path = str(tmp_path / fmt)
    files = _write(w, fmt, path)
    assert len(files) == 3
    got = _read(r, fmt, path)
    want = _read(w, fmt, path)
    assert got == want and len(got) == (12 if fmt == "numpy" else 30)
    if fmt in ("parquet", "csv", "json"):
        assert got == ITEMS


@pytest.mark.parametrize("how", ["text", "binary_files"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_text_and_binary_reads_agree(both, tmp_path, how, writer):
    """read_text / read_binary_files of the csv files one package wrote
    give the same rows through both packages."""
    path = str(tmp_path / "csv")
    both[writer].from_items(ITEMS, parallelism=3).write_csv(path)
    want = _plain(getattr(both["reference"], f"read_{how}")(path).take_all())
    got = _plain(getattr(rd, f"read_{how}")(path).take_all())
    assert got == want
    assert len(got) == (33 if how == "text" else 3)  # a header and 10 rows a file


def test_tfrecord_files_are_byte_identical(both, tmp_path):
    ref_files = both["reference"].from_items(TF_ITEMS, parallelism=3).write_tfrecords(str(tmp_path / "ref"))
    port_files = rd.from_items(TF_ITEMS, parallelism=3).write_tfrecords(str(tmp_path / "port"))
    assert [os.path.basename(f) for f in ref_files] == [os.path.basename(f) for f in port_files]
    for a, b in zip(ref_files, port_files):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_tfrecord_crc_catches_corruption_across_packages(tmp_path, writer):
    from ray_tpu.data import tfrecords as ref_tf
    from ray_tpu_torch.data import tfrecords as port_tf

    w, r = (ref_tf, port_tf) if writer == "reference" else (port_tf, ref_tf)
    path = str(tmp_path / "x.tfrecords")
    w.write_records(path, (w.encode_example({"v": i, "s": b"abc"}) for i in range(5)))
    assert len(list(r.read_records(path, verify=True))) == 5
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF  # flip a payload byte
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError):
        list(r.read_records(path, verify=True))


_NO_PANDAS = textwrap.dedent(
    """
    import json, sys
    sys.modules["pandas"] = None
    sys.modules["pyarrow"] = None
    import ray_tpu_torch
    from ray_tpu_torch import data as rd

    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    ds = rd.range(64, parallelism=4).map_batches(lambda b: {"x": b["id"] * 2})
    host = list(ds.iter_batches(batch_size=16))
    dev = list(ds.iter_device_batches(batch_size=16, device="cpu"))
    ray_tpu_torch.shutdown()
    try:
        import pandas
        blocked = False
    except ImportError:
        blocked = True
    print(json.dumps({
        "blocked": blocked,
        "host": [b["x"].tolist() for b in host],
        "dev": [b["x"].tolist() for b in dev],
        "dtype": str(dev[0]["x"].dtype),
    }))
    """
)


def test_numpy_path_runs_without_pandas_or_pyarrow():
    """range -> map_batches -> iter_batches -> iter_device_batches in a
    fresh interpreter where importing pandas or pyarrow fails."""
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", _NO_PANDAS], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["blocked"]
    want = [list(range(k * 32, k * 32 + 32, 2)) for k in range(4)]
    assert res["host"] == want and res["dev"] == want
    assert res["dtype"] == "torch.int64"


def test_device_batches_raise_without_cuda_unless_asked_for_the_cpu(rt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = rd.range(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ds.iter_device_batches(batch_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ds.iterator().iter_device_batches(batch_size=4, device="cuda")
    batches = list(ds.iter_device_batches(batch_size=4, device="cpu"))
    assert [b["id"].tolist() for b in batches] == [[0, 1, 2, 3], [4, 5, 6, 7]]


def test_device_batches_refuse_object_columns_by_name(rt):
    ds = rd.from_items([{"id": i, "name": f"n{i}"} for i in range(8)])
    with pytest.raises(TypeError, match="'name'"):
        list(ds.iter_device_batches(batch_size=4, device="cpu"))


def test_device_batches_do_not_alias_the_dataset(rt):
    """A step that writes into its batch does not write through to the
    dataset's blocks: the second epoch reads the original values."""
    ds = rd.from_numpy(np.arange(16).reshape(8, 2)).materialize()
    for batch in ds.iter_device_batches(batch_size=4, device="cpu"):
        batch["data"].zero_()
    again = [b["data"].tolist() for b in ds.iter_device_batches(batch_size=4, device="cpu")]
    assert again == np.arange(16).reshape(2, 4, 2).tolist()


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "data-prefetch" and t.is_alive()]


def _wait_until_gone(before, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not [t for t in _prefetch_threads() if t not in before]:
            return True
        time.sleep(0.05)
    return False


@pytest.mark.parametrize("how", ["break", "close_device_iterator"])
def test_abandoned_prefetch_producer_thread_ends(rt, how):
    """A loop that stops after a few batches leaves no producer thread
    behind (the reference's blocks forever in its queue's put)."""
    before = _prefetch_threads()
    ds = rd.range(4000, parallelism=20)
    if how == "break":
        for i, _batch in enumerate(ds.iter_batches(batch_size=10, prefetch_batches=1)):
            if i == 2:
                break
    else:
        it = ds.iter_device_batches(batch_size=10, prefetch_batches=1, device="cpu")
        next(it)
        next(it)
        assert [t for t in _prefetch_threads() if t not in before]
        it.close()
    assert _wait_until_gone(before), [t.name for t in _prefetch_threads()]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned-memory copy stream runs only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_device_batches_on_the_card_match_the_host_batches(rt, cuda):
    """On the card: every batch on cuda:0, bit for bit the host batch, the
    next batch's copy enqueued before a batch is handed out, and no pinned
    buffer held once the iterator is done."""
    ds = rd.range_tensor(96, shape=(8,), parallelism=4)
    host = list(ds.iter_batches(batch_size=32, drop_last=True))
    it = ds.iter_device_batches(batch_size=32)
    got = list(it)
    assert len(got) == len(host) == 3
    for g, h in zip(got, host):
        assert g["data"].device == cuda and g["data"].dtype == torch.int64
        assert torch.equal(g["data"].cpu(), torch.from_numpy(h["data"]))
    assert it.copies_ahead == 2
    for n in range(2):
        assert it.order.index(("copy", n + 1)) < it.order.index(("yield", n))
    assert not it._in_flight
