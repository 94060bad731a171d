"""What the profiling entry points share: their arguments, seeded inputs,
one measured row per variant, and its printing."""

from __future__ import annotations

import argparse
from typing import Callable, List, Optional, Sequence

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.profiling.timing import REPS, bound, time_ms


def parse(argv: Optional[Sequence[str]], description: str,
          extra: Callable[[argparse.ArgumentParser], None] = None) -> argparse.Namespace:
    """The scripts' shape (B24 S1024 H12 D64) on the card by default."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--seq", type=int, default=1024)
    p.add_argument("--heads", type=int, default=12)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: the plain versions, run once")
    if extra is not None:
        extra(p)
    return p.parse_args(list(argv) if argv is not None else None)


def device_of(args) -> tuple:
    """(device, its name): CUDA raises here when absent."""
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return device, name


def randn(device, shape, seed: int) -> torch.Tensor:
    """Normal bf16 values from `seed`, made on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(*shape, generator=gen, device=device).to(torch.bfloat16)


def bshd(t: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """A [B*H, S, D] tensor as the [B, S, H, D] view the flash kernels take."""
    bh, s, d = t.shape
    return t.view(b, h, s, d).permute(0, 2, 1, 3)


def finite(out) -> bool:
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return all(bool(torch.isfinite(t.float()).all()) for t in outs)


def measure(fn, device, reps: int = REPS) -> Optional[float]:
    """Device ms of one call on the card; None on the CPU, where no device
    time exists."""
    return time_ms(fn, reps) if device.type == "cuda" else None


def row(variant: str, kernel: str, fn, args, device, *, nbytes: float,
        flops: float, current_ms: Optional[float] = None, **extra) -> dict:
    """Run `fn` once (its outputs must be finite), time it on the card, and
    put the time beside the bound of the work: `nbytes` moved once and
    `flops` of bf16 operations."""
    out = fn()
    bh = args.batch * args.heads
    ms = measure(fn, device)
    bms, by = bound(nbytes, flops, torch.bfloat16)
    return dict(
        variant=variant, kernel=kernel, ms=ms,
        us_per_head=None if ms is None else ms * 1e3 / bh,
        bound_ms=bms, bound_by=by, flops=flops,
        tflops=None if ms is None else flops / (ms * 1e-3) / 1e12,
        current_ms=current_ms, finite=finite(out), **extra,
    )


def attention_bytes(args, lse: bool = False) -> float:
    """q, k, v and O in bf16, each once, and an f32 lse row per query."""
    n = args.batch * args.heads * args.seq
    return 4 * n * args.dim * 2 + (4 * n if lse else 0)


def attention_flops(args, causal: bool) -> float:
    """4 D flops per (query, key) pair: every pair, or the causal ones."""
    s = args.seq
    pairs = s * (s + 1) // 2 if causal else s * s
    return 4.0 * args.dim * pairs * args.batch * args.heads


def _fmt(x, spec: str) -> str:
    return "not measured" if x is None else format(x, spec)


def print_rows(title: str, args, device_name: str, rows: List[dict],
               extra_cols: Sequence[str] = ()) -> None:
    print(f"[{title}] B{args.batch} S{args.seq} H{args.heads} D{args.dim} bf16 "
          f"on {device_name}", flush=True)
    for r in rows:
        cols = [f"{r['variant']:32s}", f"{_fmt(r['ms'], '.4f')} ms/call",
                f"{_fmt(r['us_per_head'], '.3f')} us/head",
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
                f"{_fmt(r['tflops'], '.1f')} TFLOP/s",
                f"current (K2) {_fmt(r['current_ms'], '.4f')} ms"]
        cols += [f"{c} {_fmt(r[c], '.4f')} ms" for c in extra_cols]
        print("  ".join(cols), flush=True)
    if not all(r["finite"] for r in rows):
        bad = [r["variant"] for r in rows if not r["finite"]]
        raise RuntimeError(f"{title}: non-finite outputs from {bad}")

