"""A tensor-parallel rank other than 0: the loop a spawned process runs.

`parallel.tensor_parallel_group` starts one process per rank 1..tp-1:
``python -m ray_tpu_torch.llm.tp_worker RANK SIZE PORT DEVICE FD``, FD
being its end of a socket pair to rank 0. The process
takes its device (``cuda:<r>``, or the CPU with one intra-op thread),
joins the group over the TCPStore rank 0 serves, and then waits on its
pipe to rank 0 for headers:

  * a step program (``llm.model_runner``'s PREFILL .. RESTORE_BLOCK) for
    one of its runners: it receives the program's inputs by the broadcast
    that follows and runs the program on its shard (`GPTRunner.run_program`);
  * CONTROL, then a pickled message: ``("add_runner", slot, spec)`` builds
    a GPTRunner from rank 0's configs and this rank's weight shard (or the
    seed); ``("drop_runner", slot)`` frees one; ``("report",)`` answers
    with this rank's kernel launch counts (K1 ``paged_flash_attention``,
    K2 ``flash_attention_fwd``), allocated device bytes, pid and the
    collectives it has issued by kind;
    ``("reset_counters",)`` zeroes those counts;
  * STOP, or the pipe closing (rank 0 exited): it leaves the group and
    exits, freeing its device.

An exception inside a step program ends the process: its ranks could no
longer be sure to meet in the same collective, and rank 0 learns of it
from the dead process or the failed collective (TensorParallelError).
A control message that raises answers with the exception instead.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import traceback


def _counters():
    """(name, wrapper) of each kernel wrapper the serving path launches."""
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
    from ray_tpu_torch.ops.paged_flash import paged_flash_attention

    return (("paged_flash_attention", paged_flash_attention),
            ("flash_attention_fwd", flash_attention_fwd))


def _report(group, device) -> dict:
    import torch

    launches = {name: fn.launches for name, fn in _counters()}
    allocated = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    return {"launches": launches, "allocated": allocated, "pid": os.getpid(),
            "collectives": dict(group.counts)}


def _control(msg, runners: dict, group, device):
    import torch

    from ray_tpu_torch.llm.model_runner import GPTRunner

    kind = msg[0]
    if kind == "add_runner":
        _, slot, spec = msg
        runners[slot] = GPTRunner(
            spec["model_config"], spec["engine_config"], params=spec["params"],
            seed=spec["seed"], device=device, tp_group=group,
            params_are_shard=True,
        )
        return slot
    if kind == "drop_runner":
        runners.pop(msg[1], None)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return msg[1]
    if kind == "report":
        return _report(group, device)
    if kind == "reset_counters":
        for _, fn in _counters():
            fn.launches = 0
        return None
    raise ValueError(f"unknown control message {kind!r}")


def serve(conn, group, device) -> None:
    """The rank's loop (see the module doc) until STOP or rank 0's exit."""
    import numpy as np
    import torch

    from ray_tpu_torch.parallel.mesh import CONTROL, STOP

    runners: dict = {}
    while True:
        try:
            header = np.frombuffer(conn.recv_bytes(), np.int64)
        except (EOFError, OSError):
            return  # rank 0 is gone
        program = int(header[0])
        if program == STOP:
            return
        if program == CONTROL:
            msg = pickle.loads(conn.recv_bytes())
            try:
                answer = _control(msg, runners, group, device)
            except Exception as exc:  # answered, the loop goes on
                answer = exc
            conn.send_bytes(pickle.dumps(answer))
            continue
        with torch.no_grad():
            runners[int(header[1])].run_program(program, [int(x) for x in header[2:]])


def main(rank: int, size: int, port: int, device: str, conn) -> None:
    """Join the group as `rank` of `size` on `device`, then `serve`."""
    import torch
    from torch import distributed as dist

    from ray_tpu_torch.parallel.mesh import START_TIMEOUT_S, RankGroup, _make_backend

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    try:
        store = dist.TCPStore(
            "127.0.0.1", port, size, False,
            timeout=datetime.timedelta(seconds=START_TIMEOUT_S),
        )
        conn.send_bytes(b"hello")
        group = RankGroup(_make_backend(store, rank, size, device), rank, size, device)
        group.all_reduce(torch.zeros(1, device=device))
        group.counts["all_reduce"] = 0
        conn.send_bytes(pickle.dumps(("ready", os.getpid())))
        serve(conn, group, device)
    except BaseException:
        traceback.print_exc(file=sys.stderr)
        sys.stderr.flush()
        os._exit(1)
    group.shutdown()
    conn.close()


if __name__ == "__main__":
    from multiprocessing.connection import Connection

    _rank, _size, _port, _device, _fd = sys.argv[1:6]
    main(int(_rank), int(_size), int(_port), _device, Connection(int(_fd)))
