"""Device timing of one call on the card, and the least time the card
could take for a given amount of work (its bound).

Numbers are for an NVIDIA H100 SXM at its published peaks: 3.35 TB/s of
HBM3, 989 TFLOP/s of dense bf16 and 67 TFLOP/s of f32 outside the tensor
cores. A card run below its 700 W power limit is slower than these.
"""

from __future__ import annotations

import statistics
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, per type
REPS = 20

_flush_buf = None


def time_ms(fn, reps: int = REPS) -> float:
    """Device time of one call: median of CUDA-event timings of single
    calls, the 50 MB L2 flushed before each (the serving path reads each
    layer's pool cold). The card is parked on a spin kernel while the host
    enqueues the call, so the events bracket device work only, not the
    Python wrapper's host time."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # Spin long enough to cover the host's enqueue several times over
    # (the card clocks below 2 GHz, so 2e9 cycles/s over-covers).
    spin = int(max(2e6, 8 * enqueue_s * 2e9))
    times = []
    for _ in range(reps):
        _flush_buf.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the operations over the peak rate of `dtype`."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")
