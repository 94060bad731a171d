"""Where the bf16 forward's time goes: the dissected forward (K8), level by
level. The port's counterpart of ``benchmarks/profile_attn_dissect.py``.

    python -m ray_tpu_torch.profiling.attn_dissect [--device cuda|cpu] ...

Rows, in the script's order: "dots only" (level 0: q kᵀ and P V with no
scale, mask or softmax), "+ mask" (1), "+ max" (2), "+ exp" (3), "full
softmax" (4), "full softmax, 2 heads/block" (the script's make2h(3)); and
first "current", K2 (`flash_attention_fwd`, causal, sm_scale 1) at the same
shape. Levels 0-2 compute every (query, key) pair and are not attention
(see ``ops/csrc/attn_dissect.cu``); from level 2 on the kernel takes two
passes over the keys, one for each row's max (and sum), one for P V.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

from ray_tpu_torch.ops.attn_profile import attn_dissect
from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
from ray_tpu_torch.profiling import _common as c

VARIANTS = (
    ("dots only", 0, False),
    ("dots + mask", 1, False),
    ("dots + mask + max", 2, False),
    ("dots + mask + max + exp", 3, False),
    ("full softmax", 4, False),
    ("full softmax, 2 heads/block", 3, True),
)


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    args = c.parse(argv, __doc__.splitlines()[0])
    device, name = c.device_of(args)
    b, h = args.batch, args.heads
    shape = (b * h, args.seq, args.dim)
    q, k, v = (c.randn(device, shape, i) for i in range(3))
    nbytes = c.attention_bytes(args)
    causal_flops = c.attention_flops(args, causal=True)
    current = c.row(
        "current (K2 flash_fwd)", "K2",
        lambda: flash_attention_fwd(c.bshd(q, b, h), c.bshd(k, b, h),
                                    c.bshd(v, b, h), causal=True, sm_scale=1.0),
        args, device, nbytes=c.attention_bytes(args, lse=True), flops=causal_flops)
    current["current_ms"] = current["ms"]
    rows = [current]
    for variant, level, two_heads in VARIANTS:
        skips = level >= 3 or two_heads  # tiles above the diagonal skipped
        rows.append(c.row(
            variant, "K8", lambda: attn_dissect(q, k, v, level, two_heads=two_heads),
            args, device, nbytes=nbytes,
            flops=c.attention_flops(args, causal=skips),
            current_ms=current["ms"], level=level, two_heads=two_heads))
    c.print_rows("attn_dissect", args, name, rows)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
