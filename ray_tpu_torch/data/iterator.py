"""DataIterator: batched consumption with prefetch.

Reference: data/iterator.py + _internal/block_batching/ — blocks stream from
the executor, a background thread prefetches and re-chunks them into
fixed-size batches in the requested format. Fixed batch sizes keep a train
step's shapes static (the reference's XLA recompiles on a shape change; on
the card a fixed shape keeps the allocator's blocks and the kernels' grids
the same); `drop_last=True` plus bucketed padding upstream keeps them so.

`iter_device_batches` is the one place where data touches the card: each
batch is copied from pinned host memory on a copy stream of its own, one
batch ahead of the consumer (`DeviceBatchIterator`).
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Any, Callable, Generator, Iterator, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import BlockAccessor, DelegatingBlockBuilder, batch_to_format


class DataIterator:
    """Iterable over batches; each __iter__ restarts the underlying plan
    (one epoch), unless constructed over a fixed block stream."""

    def __init__(self, make_stream: Callable[[], Iterator], owner=None):
        self._make_stream = make_stream
        self._owner = owner  # Dataset, for stats/repr

    def iter_batches(
        self,
        *,
        batch_size: int = 256,
        batch_format: str = "numpy",
        drop_last: bool = False,
        prefetch_batches: int = 2,
        local_shuffle_buffer_size: Optional[int] = None,
        local_shuffle_seed: Optional[int] = None,
    ) -> Iterator[Any]:
        stream = self._make_stream()

        def block_iter():
            for block_ref, _meta in stream:
                yield ray_tpu_torch.get(block_ref)

        batches = _rebatch(
            block_iter(),
            batch_size,
            batch_format,
            drop_last,
            local_shuffle_buffer_size,
            local_shuffle_seed,
        )
        if prefetch_batches and prefetch_batches > 0:
            batches = _prefetch(batches, prefetch_batches)
        return batches

    def iter_device_batches(
        self,
        *,
        batch_size: int = 256,
        device="cuda",
        drop_last: bool = True,
        prefetch_batches: int = 2,
        **kwargs,
    ) -> "DeviceBatchIterator":
        """iter_batches + double-buffered host→device copy: batch N+1's copy
        is ENQUEUED (on a copy stream, from pinned memory) before batch N is
        yielded, so the copy overlaps the consumer's train step — the
        feed-the-accelerator layer (reference block_batching/iter_batches.py's
        prefetching collated iterator). `device` takes the place of the
        reference's `sharding`: the card by default, which raises without
        CUDA; pass "cpu" to get host tensors. Columns keep numpy's dtype
        (int64 stays int64, as `F.cross_entropy` wants its targets).
        drop_last defaults True: fixed shapes on every step."""
        from ray_tpu_torch._private.device import resolve_device

        dev = resolve_device(device)
        host = self.iter_batches(
            batch_size=batch_size,
            batch_format="numpy",
            drop_last=drop_last,
            prefetch_batches=prefetch_batches,
            **kwargs,
        )
        return DeviceBatchIterator(host, dev)

    def iter_rows(self) -> Iterator[Any]:
        for block_ref, _ in self._make_stream():
            yield from BlockAccessor.for_block(ray_tpu_torch.get(block_ref)).iter_rows()

    def __iter__(self):
        return self.iter_batches()

    def materialize_refs(self) -> list:
        return list(self._make_stream())


def _rebatch(
    blocks: Iterator[Any],
    batch_size: int,
    batch_format: str,
    drop_last: bool,
    shuffle_buffer: Optional[int],
    shuffle_seed: Optional[int],
) -> Iterator[Any]:
    """Slice a stream of blocks into exact-size batches."""
    import random

    rng = random.Random(shuffle_seed)
    builder = DelegatingBlockBuilder()
    pending_rows = 0

    def drain(builder, want):
        block = builder.build()
        acc = BlockAccessor.for_block(block)
        n = acc.num_rows()
        out = []
        start = 0
        while n - start >= want:
            out.append(acc.slice(start, start + want))
            start += want
        rest = DelegatingBlockBuilder()
        if start < n:
            rest.add_batch(acc.slice(start, n))
        return out, rest, n - start

    if shuffle_buffer:
        # Local shuffle: accumulate rows into a bounded buffer, emit randomly.
        buffer: list = []

        def shuffled_rows():
            for block in blocks:
                for row in BlockAccessor.for_block(block).iter_rows():
                    buffer.append(row)
                    if len(buffer) >= shuffle_buffer:
                        idx = rng.randrange(len(buffer))
                        buffer[idx], buffer[-1] = buffer[-1], buffer[idx]
                        yield buffer.pop()
            rng.shuffle(buffer)
            yield from buffer

        row_iter = shuffled_rows()
        batch_rows: list = []
        for row in row_iter:
            batch_rows.append(row)
            if len(batch_rows) == batch_size:
                yield batch_to_format(batch_rows, batch_format)
                batch_rows = []
        if batch_rows and not drop_last:
            yield batch_to_format(batch_rows, batch_format)
        return

    for block in blocks:
        builder.add_batch(block)
        pending_rows += BlockAccessor.for_block(block).num_rows()
        if pending_rows >= batch_size:
            full, builder, pending_rows = drain(builder, batch_size)
            for piece in full:
                yield batch_to_format(piece, batch_format)
    if pending_rows and not drop_last:
        yield batch_to_format(builder.build(), batch_format)


PREFETCH_PUT_TIMEOUT_S = 0.1


def _prefetch(it: Generator[Any, None, None], depth: int) -> Iterator[Any]:
    """Run `it` on a producer thread, `depth` items ahead. The producer
    stops when the consumer closes this generator (a `break` out of its
    loop, or the generator collected): its puts time out and re-check a stop
    flag, so it never waits forever on a queue nobody reads, and it closes
    `it` on its way out (the reference's producer blocks in `q.put` for
    good, holding its batches)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    DONE = object()
    err: list = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=PREFETCH_PUT_TIMEOUT_S)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as e:
            err.append(e)
        finally:
            if stop.is_set():
                it.close()
            put(DONE)

    t = threading.Thread(target=produce, daemon=True, name="data-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is DONE:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


def _column_tensor_dtype(name: str, arr: np.ndarray):
    import torch

    try:
        return torch.from_numpy(np.empty(0, dtype=arr.dtype)).dtype
    except TypeError:
        raise TypeError(
            f"iter_device_batches: column {name!r} has dtype {arr.dtype}, which "
            "has no tensor type (object and string columns cannot go to a "
            "device; drop or encode them first)"
        ) from None


class DeviceBatchIterator:
    """Batches of `iter_batches(batch_format="numpy")` as dicts of tensors
    on `device`, each copied one batch ahead of the consumer.

    On the card every column is written into a pinned host tensor of its
    dtype and copied with `non_blocking=True` on a copy stream of this
    iterator's (a copy from pageable memory would be synchronous and
    overlap nothing); an event recorded after the copies marks the batch
    ready. Before a batch is handed out the consumer's current stream waits
    on that event and each tensor is recorded as used by that stream, so
    the caching allocator does not reuse its memory under the consumer's
    work. The pinned buffers stay referenced until their event completes.
    On the CPU each column is copied into a host tensor.

    `order` logs ("copy", n) when batch n's copies are enqueued and
    ("yield", n) when it is handed out; `copies_ahead` counts the batches
    handed out after the next batch's copy was enqueued. Closing the
    iterator (or dropping it) closes the host stream, which stops its
    prefetch thread."""

    def __init__(self, host: Generator[Any, None, None], device):
        import torch

        self._host = host
        self.device = device
        self.order: list = []
        self.copies_ahead = 0
        self._stream = (
            torch.cuda.Stream(device=device) if device.type == "cuda" else None
        )
        self._in_flight: deque = deque()  # (event, pinned buffers)
        self._gen = self._run()

    def __iter__(self) -> "DeviceBatchIterator":
        return self

    def __next__(self) -> dict:
        return next(self._gen)

    def close(self) -> None:
        self._gen.close()

    def _issue(self, batch: dict, n: int) -> tuple:
        import torch

        on_card = self._stream is not None
        host = {}
        for k, v in batch.items():
            t = torch.empty(np.shape(v), dtype=_column_tensor_dtype(k, np.asarray(v)),
                            pin_memory=on_card)
            t.numpy()[...] = v
            host[k] = t
        out, event = host, None
        if on_card:
            with torch.cuda.stream(self._stream):
                out = {k: t.to(self.device, non_blocking=True) for k, t in host.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
            self._in_flight.append((event, host))
        self.order.append(("copy", n))
        return out, event

    def _hand_out(self, issued: tuple, n: int) -> dict:
        import torch

        out, event = issued
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in out.values():
                t.record_stream(consumer)
        while self._in_flight and self._in_flight[0][0].query():
            self._in_flight.popleft()
        if self.order[-1] == ("copy", n + 1):  # the next batch's copy is issued
            self.copies_ahead += 1
        self.order.append(("yield", n))
        return out

    def _run(self):
        pending = None
        n = 0
        try:
            for batch in self._host:
                issued = self._issue(batch, n)  # the copy starts now
                if pending is not None:
                    yield self._hand_out(pending, n - 1)
                pending = issued
                n += 1
            if pending is not None:
                yield self._hand_out(pending, n - 1)
        finally:
            self._host.close()
            for event, _ in self._in_flight:
                event.synchronize()
            self._in_flight.clear()


class _SplitCoordinator:
    """Feeds N consumers from one block stream (reference: OutputSplitter,
    operators/output_splitter.py, behind Dataset.streaming_split).

    Each epoch = one pass of the plan, with its OWN set of per-consumer
    bounded queues (so concurrent epochs never interleave in one queue, and
    a rank that abandons an epoch mid-stream starts the next epoch on a
    clean queue). An epoch's feeder thread starts lazily when the first rank
    asks for it; it ends the epoch with one DONE sentinel per queue. Queues
    are dropped once every rank has finished (or skipped past) the epoch.

    equal=True assigns each bundle to the consumer with the fewest rows so
    far (greedy row balancing); equal=False round-robins whole blocks.
    """

    def __init__(self, make_stream: Callable[[], Iterator], n: int, equal: bool):
        self._make_stream = make_stream
        self._n = n
        self._equal = equal
        self._epoch_queues: dict = {}
        self._epoch_finished: dict = {}
        self._epochs_consumed = [0] * n
        self._lock = threading.Lock()
        self._DONE = object()

    def _feed(self, queues) -> None:
        rows_sent = [0] * self._n
        i = 0
        try:
            for bundle in self._make_stream():
                if self._equal:
                    target = min(range(self._n), key=lambda r: rows_sent[r])
                else:
                    target = i % self._n
                n_rows = bundle[1].num_rows if bundle[1] is not None else None
                rows_sent[target] += n_rows or 1
                queues[target].put(bundle)
                i += 1
        finally:
            for q in queues:
                q.put(self._DONE)

    def stream_for(self, rank: int) -> Iterator:
        with self._lock:
            epoch = self._epochs_consumed[rank]
            self._epochs_consumed[rank] += 1
            if epoch not in self._epoch_queues:
                queues = [queue.Queue(maxsize=4) for _ in range(self._n)]
                self._epoch_queues[epoch] = queues
                self._epoch_finished[epoch] = 0
                threading.Thread(
                    target=self._feed, args=(queues,), daemon=True
                ).start()
            q = self._epoch_queues[epoch][rank]
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    return
                yield item
        finally:
            with self._lock:
                self._epoch_finished[epoch] += 1
                if self._epoch_finished[epoch] == self._n:
                    self._epoch_queues.pop(epoch, None)
                    self._epoch_finished.pop(epoch, None)
