"""Flash attention variants at the GPT-2 shapes: the port's forward and
backward ("current") against the slim forward (K9) over its tiles. The
port's counterpart of ``benchmarks/profile_attn_variants.py``.

    python -m ray_tpu_torch.profiling.attn_variants [--device cuda|cpu] ...

Rows, in the script's order: "current", the port's `flash_attention`
(K2 forward; at S <= 1024 the one-block backward K3, by the reference's
block rule, else K4 + K5), then "slim BMxBN" for query and key tiles in
{64, 128}: `slim_attention`, K9 forward and the K4 + K5 backward, as the
script's `make_variant` pairs its slim forward with `_flash_bwd_pallas`.
The script's 1024/512/256-row TPU blocks do not fit an SM's shared memory;
these tiles are the H100's sweep (``ops/csrc/attn_slim.cu``). Each row
gives the forward kernel's time per call beside its bound, and, as the
script's `run_fwd` and `run` do, the forward and the forward + backward
over `--layers` (12) chained layers (each layer attends over the previous
layer's output, q = k = v).
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

import torch

from ray_tpu_torch.ops.attn_profile import SLIM_TILES, _fold, flash_fwd_slim, slim_attention
from ray_tpu_torch.ops.flash_attention import flash_attention, flash_attention_fwd
from ray_tpu_torch.profiling import _common as c

TILES = tuple((bm, bn) for bm in SLIM_TILES for bn in SLIM_TILES)
CHAIN_REPS = 5  # timed calls of each 12-layer chain


def _chain(attn, x: torch.Tensor, layers: int, backward: bool):
    """`layers` chained attention layers on x, as the script's run / run_fwd:
    the forward's sum, or the gradient of that sum with respect to x."""
    if not backward:
        with torch.no_grad():
            y = x
            for _ in range(layers):
                y = attn(y, y, y)
            return y.float().sum()
    x = x.detach().requires_grad_()
    y = x
    for _ in range(layers):
        y = attn(y, y, y)
    return torch.autograd.grad(y.float().sum(), x)[0]


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    args = c.parse(argv, __doc__.splitlines()[0], extra=lambda p: p.add_argument(
        "--layers", type=int, default=12, help="chained layers (the script's 12)"))
    device, name = c.device_of(args)
    b, s, h, d = args.batch, args.seq, args.heads, args.dim
    x = c.randn(device, (b, s, h, d), 3)
    q, k, v = (c.randn(device, (b, s, h, d), i) for i in range(3))
    qf, kf, vf = _fold(q), _fold(k), _fold(v)
    nbytes = c.attention_bytes(args, lse=True)
    flops = c.attention_flops(args, causal=True)

    def variant(label, kernel, fwd, attn, current_ms=None, **extra):
        r = c.row(label, kernel, fwd, args, device, nbytes=nbytes, flops=flops,
                  current_ms=current_ms, **extra)
        for key, backward in (("fwd_chain_ms", False), ("fwd_bwd_chain_ms", True)):
            chain = lambda: _chain(attn, x, args.layers, backward)
            r["finite"] = r["finite"] and c.finite(chain())
            r[key] = c.measure(chain, device, CHAIN_REPS)
        return r

    current = variant(
        "current (K2 fwd, K3 or K4 + K5 bwd)", "K2",
        lambda: flash_attention_fwd(q, k, v, causal=True),
        lambda a, b_, c_: flash_attention(a, b_, c_, causal=True))
    current["current_ms"] = current["ms"]
    rows = [current]
    for bm, bn in TILES:
        rows.append(variant(
            f"slim {bm}x{bn} (K9 fwd, K4 + K5 bwd)", "K9",
            lambda: flash_fwd_slim(qf, kf, vf, block_q=bm, block_k=bn),
            lambda a, b_, c_: slim_attention(a, b_, c_, block_q=bm, block_k=bn),
            current_ms=current["ms"], block_q=bm, block_k=bn))
    c.print_rows("attn_variants", args, name, rows,
                 extra_cols=("fwd_chain_ms", "fwd_bwd_chain_ms"))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
