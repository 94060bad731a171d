"""The single-program subtiled causal forward (K10) at T = 2, 4, 8 against
the bf16 forward (K2). The port's counterpart of
``benchmarks/profile_attn_subtile.py``.

    python -m ray_tpu_torch.profiling.attn_subtile [--device cuda|cpu] ...

Rows, in the script's order: "current", K2 (`flash_attention_fwd`, causal,
sm_scale 1, as the script calls its forward on unscaled q), then
"subtiled T=2", "T=4", "T=8": causal attention without scale whose rows
are cut into T chunks, each scoring keys up to its chunk's edge. The output
does not depend on T; the work does (masked keys past the diagonal, within
the diagonal chunk, are computed).
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

from ray_tpu_torch.ops.attn_profile import attn_subtile
from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
from ray_tpu_torch.profiling import _common as c

TS = (2, 4, 8)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    args = c.parse(argv, __doc__.splitlines()[0])
    device, name = c.device_of(args)
    b, h = args.batch, args.heads
    shape = (b * h, args.seq, args.dim)
    q, k, v = (c.randn(device, shape, i) for i in range(3))
    nbytes = c.attention_bytes(args, lse=True)
    flops = c.attention_flops(args, causal=True)
    current = c.row(
        "current (K2 flash_fwd)", "K2",
        lambda: flash_attention_fwd(c.bshd(q, b, h), c.bshd(k, b, h),
                                    c.bshd(v, b, h), causal=True, sm_scale=1.0),
        args, device, nbytes=nbytes, flops=flops)
    current["current_ms"] = current["ms"]
    rows = [current]
    for t in TS:
        rows.append(c.row(f"subtiled T={t}", "K10", lambda: attn_subtile(q, k, v, t),
                          args, device, nbytes=nbytes, flops=flops,
                          current_ms=current["ms"], T=t))
    c.print_rows("attn_subtile", args, name, rows)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
