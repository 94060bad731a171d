#!/usr/bin/env python3
"""On-card smoke test of ray_tpu_torch, the PyTorch / CUDA port.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device  — the card's name and power limit (nvidia-smi) and torch's name;
  2. build   — compile every CUDA kernel from ray_tpu_torch/ops/csrc, and
     count the tensor-core instructions (HMMA / HGMMA, by cuobjdump) of the
     bf16 forward kernel, of the bf16 dQ and dK/dV kernels and of every
     profiling kernel (K8-K10): none fails the run;
  3. kernels — hold each kernel against its plain PyTorch version at the
     serving and training paths' GPT-2 125M shapes (H=12, D=64), with stated
     tolerances; time kernel, plain version, the bound and, where one
     PyTorch call computes the same function, that call (a yardstick only);
     K2-K7 rows also print their achieved TFLOP/s, and K2, K3 and K6 the
     time of the CUDA-core kernel they replaced (`earlier_ms`); K3 at the
     trainer's shape also has its two launches timed apart, with its
     workspace and peak memory, and is timed once more at head_dim 128; K3, K4, K5 and K7 run twice on the same inputs and must
     give dq, dk and dv bit for bit;
  4. profile — the profiling entry points (ray_tpu_torch.profiling:
     attn_dissect, attn_variants, attn_subtile) at the reference scripts'
     B24 S1024 H12 D64 bf16, each with its kernel's launch counter zeroed
     just before and read just after; then every K8 level and the two-head
     variant, every K9 tile and every K10 T against its plain version;
  5. train   — GPT-2 125M (bf16 compute on f32 params) takes 5 fused_adamw
     steps at B=8, S=1024 through the packed kernels (K6, K7): finite
     losses that fall, both kernels launched 12 per step, step time,
     tokens/s and the card's busy share under torch.profiler; then the
     long-context branch at B=1, S=4096 (K2, K4, K5) for 2 steps; then f32
     parity of one step (loss, every gradient, the parameters after the
     update) between the kernels and the plain attention path;
  6. trainer — the same model with attention_impl="auto" trains through
     ray_tpu_torch.train.TorchTrainer on a worker actor of the in-process
     runtime (cuda:0): 5 steps at B=8, S=1024 through K2 and the one-block
     backward K3 (12 launches each per step, K4-K7 none), losses that fall,
     a checkpoint of the parameters and both moments; a second fit() resumes
     from it bit for bit and takes step 5; then f32 parity of one "auto"
     step against the plain attention path;
  7. server  — LLMServer serves GPT-2 125M (random seeded weights) to 8
     concurrent requests; asserts they all finish, the prefix cache hit,
     and both kernels launched on that run; then f32 on the kernels must
     be token-identical to f32 on the plain versions, one request at a
     time through the servers and all 8 live together in one batch.
The last two lines are the kernels JSON and the {"ok": true, ...} contract.
"""

from __future__ import annotations

import importlib
import json
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

# Run from the repository root: the port's package sits beside this file.
from ray_tpu_torch.profiling.timing import bound, time_ms

# Kernel against plain version, per output and by the output's dtype (see
# `compare`): relative L2 error, and every element within `ulps` rounding
# steps of its plain value plus `floor_rms` times the output's RMS.
LIMITS = {
    torch.float32: dict(ulps=4, floor_rms=1e-4, rel_l2=1e-5),
    torch.bfloat16: dict(ulps=2, floor_rms=5e-2, rel_l2=1e-2),
}
H, D, BS, NB = 12, 64, 16, 64  # GPT-2 125M heads/width; the server's cache
# Training shapes: the packed path (S <= 2048) and the long-context branch.
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 1024, 5
LONG_B, LONG_S, LONG_STEPS = 1, 4096, 2
PARITY_B, PARITY_S, PARITY_LONG_LAYERS = 2, 1024, 2
# The profiling entry points' default shape (the reference scripts' B24
# S1024 H12 D64 bf16), at which K8-K10 are held against their plain versions.
PROF_B, PROF_S = 24, 1024
LR = 3e-4
GRAD_FLOOR = 10 * 1e-8  # 10 x fused_adamw's eps: see _f32_parity
# Times of the kernels before their tensor-core versions (f32 math on the
# CUDA cores in both types), ms, on an H100 80GB HBM3 at 700 W (PERF.md):
# K2 / K6 from this script's kernel phase run on commit 771fee6, K3 from its
# run on commit 1349e5b. Keys: kernel, case, S, causal, dtype.
EARLIER_MS = {
    ("K3 flash_bwd_fused", "train", 1024, True, "bf16"): 4.112,
    ("K2 flash_fwd", "prefill", 128, True, "bf16"): 0.0486,
    ("K2 flash_fwd", "prefill", 128, True, "f32"): 0.0483,
    ("K2 flash_fwd", "prefill", 200, True, "bf16"): 0.0666,
    ("K2 flash_fwd", "prefill", 200, True, "f32"): 0.0650,
    ("K2 flash_fwd", "prefill", 256, True, "bf16"): 0.0836,
    ("K2 flash_fwd", "prefill", 256, True, "f32"): 0.0828,
    ("K2 flash_fwd", "prefill", 1000, True, "bf16"): 0.4012,
    ("K2 flash_fwd", "prefill", 1000, True, "f32"): 0.3930,
    ("K2 flash_fwd", "prefill", 1024, True, "bf16"): 0.4069,
    ("K2 flash_fwd", "prefill", 1024, True, "f32"): 0.3992,
    ("K2 flash_fwd", "prefill", 1024, False, "bf16"): 0.5630,
    ("K2 flash_fwd", "prefill", 1024, False, "f32"): 0.5670,
    ("K2 flash_fwd", "train", 1024, True, "bf16"): 1.9456,
    ("K2 flash_fwd", "train", 1024, True, "f32"): 1.9217,
    ("K6 flash_fwd_packed", "train", 1024, True, "bf16"): 1.9600,
    ("K6 flash_fwd_packed", "train", 1024, True, "f32"): 1.8940,
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def sdpa_bwd_ms(q, k, v, do) -> float:
    """Device time of SDPA's backward on the same inputs ([B, S, H, D],
    viewed as [B, H, S, D]): one torch.autograd.grad call through the graph
    of one SDPA forward, timed as the kernels are (time_ms). It computes
    dQ, dK and dV together. A yardstick only."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    grad = do.transpose(1, 2)
    return time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), grad, retain_graph=True))


def compare(got: torch.Tensor, want: torch.Tensor, per_row: bool = False) -> dict:
    """One kernel output against its plain version: the largest absolute
    error, the relative L2 error of the whole output, and how far the worst
    element lies past ULPS rounding steps of its plain value, in units of
    the output's RMS (elements near zero, where sums cancel, need that
    floor; a zeroed or mis-masked element lies a whole value past). With
    `per_row`, each row (the last dim) is also held against its own RMS and
    L2 norm, and the worse of the two readings is kept: K8's levels 1-2 mix
    rows of ~1e31 (masked keys add -1e30 v) with rows of ~1e2 (no masked
    key), which the whole output's scale alone would not see."""
    g, w = got.double(), want.double()  # K8's outputs reach ~1e31: no f32 squares
    diff = (g - w).abs()
    eps = torch.finfo(want.dtype).eps  # one rounding step relative to |w|
    excess = diff - LIMITS[want.dtype]["ulps"] * eps * w.abs()
    rms = w.pow(2).mean().sqrt().clamp_min(1e-30)
    out = dict(
        max_abs_err=diff.max().item(),
        rel_l2=(diff.norm() / w.norm().clamp_min(1e-30)).item(),
        floor_rms=(excess.max() / rms).item(),
        rms=rms.item(),
    )
    if per_row:
        row_rms = w.pow(2).mean(-1, keepdim=True).sqrt().clamp_min(1e-30)
        row_l2 = diff.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
        out.update(rel_l2=max(out["rel_l2"], row_l2.max().item()),
                   floor_rms=max(out["floor_rms"], (excess / row_rms).max().item()),
                   min_row_rms=row_rms.min().item())
    return out


def dtype_label(dtype) -> str:
    return {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype]


def check_close(rows: list, name: str, got: dict, want: dict, label: str,
                per_row: bool = False, **shape) -> None:
    """Record a kernel-vs-plain row and fail if any output, each held on its
    own, passes its dtype's LIMITS (lse is f32 whatever the inputs)."""
    outs = {k: compare(got[k], want[k], per_row) for k in want}
    rows.append(dict(kernel=name, dtype=label, **shape,
                     max_abs_err=max(o["max_abs_err"] for o in outs.values()),
                     outputs=outs))
    for k, o in outs.items():
        lim = LIMITS[want[k].dtype]
        if not (o["rel_l2"] <= lim["rel_l2"] and o["floor_rms"] <= lim["floor_rms"]):
            fail(f"{name} {shape} {label} {k}: {o} past {lim}")


# ---------------------------------------------------------------- phases


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch: {name}, {torch.__version__}, CUDA {torch.version.cuda}, "
        f"devices={torch.cuda.device_count()}")
    return {"smi": card, "name": name}


def phase_build() -> None:
    from ray_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    report = _kernels.build()
    for name, info in report.items():
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln or "entry function" in ln]
        log(f"[build] {name}: {info['seconds']:.1f}s")
        for ln in ptxas:
            log(f"[build]   {ln}")
    log(f"[build] total {time.perf_counter() - t0:.1f}s "
        f"({len(report)} compiled, {len(_kernels.KERNELS) - len(report)} cached)")
    # The tensor-core kernels, by library and name: the bf16 forward (K2,
    # K6), the bf16 dQ and dK/dV kernels (K4, K5, K7), the bf16 one-block
    # backward (K3), and the profiling kernels (K8-K10) throughout ("" names
    # every function). A name with no function, or a function with no HMMA /
    # HGMMA instruction, fails.
    for lib, names in (("flash_fwd", ("flash_fwd_mma_kernel",)),
                       ("flash_bwd", ("flash_bwd_dq_mma_kernel",
                                      "flash_bwd_dkv_mma_kernel")),
                       ("flash_bwd_fused", ("flash_bwd_fused_mma_kernel",)),
                       ("attn_dissect", ("",)), ("attn_slim", ("",)),
                       ("attn_subtile", ("",))):
        mma = tensor_core_instructions(_kernels, lib)
        log(f"[build] {lib} tensor-core instructions (cuobjdump): {json.dumps(mma)}")
        for name in names:
            found = {fn: n for fn, n in mma.items() if name in fn}
            if not found or not all(found.values()):
                fail(f"a {lib} kernel {name!r} has no HMMA / HGMMA instruction: "
                     f"{found or mma}")


def tensor_core_instructions(kernels, name: str) -> dict:
    """HMMA / HGMMA instructions in each kernel function of one built
    library, from the CUDA toolkit's cuobjdump --dump-sass."""
    cuobjdump = str(Path(kernels._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(kernels._library_path(name))],
                          capture_output=True, text=True, timeout=120)
    if sass.returncode != 0:
        fail(f"cuobjdump: {sass.stderr.strip()}")
    counts, fn = {}, None
    for line in sass.stdout.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts.setdefault(fn, 0)
        elif fn is not None and re.search(r"\bHG?MMA\b", line):
            counts[fn] += 1
    return counts


def check_bitwise_repeat(rows: list, got: dict, again: dict, what: str) -> None:
    """A second run on the same inputs must give every output bit for bit
    (the kernels sum in a fixed order, with no atomics)."""
    same = {n: torch.equal(again[n], got[n]) for n in got}
    rows[-1]["bitwise_repeat"] = same
    if not all(same.values()):
        fail(f"{what}: a second run differs: {same}")


def tflops(row: dict, flops: float) -> None:
    """Achieved TFLOP/s of a timed row, and the earlier kernel's time of the
    same row (EARLIER_MS)."""
    key = (row["kernel"], row["case"], row["S"], row.get("causal", True), row["dtype"])
    row.update(tflops=flops / (row["ms"] * 1e-3) / 1e12, earlier_ms=EARLIER_MS.get(key))


def _paged_case(gen, b, s, ctx, dtype, kv):
    from ray_tpu_torch.ops.paged_flash import quantize_kv

    n_blocks = 1 + b * NB
    dev = "cuda"
    store = torch.float32 if kv == "int8" else dtype
    q = torch.randn(b, s, H, D, generator=gen, device=dev).to(dtype)
    kc = torch.randn(n_blocks, BS, H, D, generator=gen, device=dev).to(store)
    vc = torch.randn(n_blocks, BS, H, D, generator=gen, device=dev).to(store)
    nk = torch.randn(b, s, H, D, generator=gen, device=dev).to(dtype)
    nv = torch.randn(b, s, H, D, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    tables = perm.view(b, NB).to(torch.int32).contiguous()
    lens = torch.tensor(ctx, dtype=torch.int32, device=dev)
    # Null-pad each table past its context, as the engine does.
    used = (lens + BS - 1) // BS
    tables = torch.where(
        torch.arange(NB, device=dev)[None, :] < used[:, None], tables, 0
    ).to(torch.int32)
    ks = vs = None
    if kv == "int8":
        kc, ks = quantize_kv(kc)
        vc, vs = quantize_kv(vc)
    return q, kc, vc, tables, lens, nk, nv, ks, vs


def phase_kernels() -> list:
    from ray_tpu_torch.ops.attention import paged_attention
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_reference,
    )
    from ray_tpu_torch.ops.paged_flash import paged_flash_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    decode_ctx = [0, 1, 15, 16, 17, 64, 100, 255, 256, 300, 511, 512, 640,
                  777, 1000, 1023]
    cases = [
        ("decode", 16, 1, decode_ctx),
        ("suffix", 1, 256, [512]),
        ("verify", 16, 5, [min(c, 1019) for c in decode_ctx]),
    ]
    for label, b, s, ctx in cases:
        for dtype, kv in ((torch.bfloat16, "bf16"), (torch.float32, "f32"),
                          (torch.bfloat16, "int8")):
            q, kc, vc, tables, lens, nk, nv, ks, vs = _paged_case(
                gen, b, s, ctx, dtype, kv
            )
            kern = lambda: paged_flash_attention(
                q, kc, vc, tables, lens, new_k=nk, new_v=nv, k_scale=ks,
                v_scale=vs,
            )
            # The plain version on the same (prescaled) inputs: the CPU
            # branch of the wrapper, run here on the card's tensors.
            sm = 1.0 / D ** 0.5
            qs = (q.float() * sm).to(q.dtype)
            plain = lambda: paged_attention(
                qs, kc, vc, tables, lens, new_k=nk, new_v=nv, sm_scale=1.0,
                k_scale=ks, v_scale=vs,
            )
            check_close(rows, "K1 paged_attention", {"o": kern()}, {"o": plain()},
                        kv, case=label, B=b, S=s, ctx_max=max(ctx))
            ms, plain_ms = time_ms(kern), time_ms(plain, reps=10)
            qb = dtype.itemsize
            kvb = 1 if kv == "int8" else qb
            tokens = sum(ctx)
            nbytes = (
                4 * b * s * H * D * qb          # q, new_k, new_v, out
                + 2 * tokens * H * D * kvb      # cached K and V to ctx
                + (2 * tokens * H * 2 if kv == "int8" else 0)
                + b * NB * 4 + b * 4            # tables, lens
            )
            pairs = sum(s * c for c in ctx) + b * s * (s + 1) // 2
            bms, by = bound(nbytes, 4 * D * H * pairs, dtype)
            rows[-1].update(ms=ms, plain_ms=plain_ms, library_ms=None,
                            bound_ms=bms, bound_us=bms * 1e3, bound_by=by)
            log(json.dumps(rows[-1]))
    # Prefill lengths (S = 200 and 1000 end inside a 64-row tile), and one
    # non-causal row.
    for s, causal in ((128, True), (200, True), (256, True), (1000, True),
                      (1024, True), (1024, False)):
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn(1, s, 3 * H * D, generator=gen, device="cuda").to(dtype)
            q, k, v = (t.view(1, s, H, D) for t in qkv.split(H * D, dim=-1))
            kern = lambda: flash_attention_fwd(q, k, v, causal=causal)
            plain = lambda: flash_attention_reference(q, k, v, causal=causal)
            got, want = (dict(zip(("o", "lse"), f())) for f in (kern, plain))
            check_close(rows, "K2 flash_fwd", got, want, dtype_label(dtype),
                        case="prefill", B=1, S=s, causal=causal)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library = lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal
            )
            ms, plain_ms = time_ms(kern), time_ms(plain, reps=10)
            lib_ms = time_ms(library)
            nbytes = 4 * s * H * D * dtype.itemsize + H * s * 4
            flops = 4 * D * H * (s * (s + 1) // 2 if causal else s * s)
            bms, by = bound(nbytes, flops, dtype)
            rows[-1].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bms, bound_us=bms * 1e3, bound_by=by)
            tflops(rows[-1], flops)
            log(json.dumps(rows[-1]))
    training_kernel_rows(gen, rows)
    pick = {r["kernel"]: r for r in rows
            if r.get("case") == "train" and r["dtype"] == "bf16"}
    k3, k4, k5, k7 = (pick[n] for n in ("K3 flash_bwd_fused", "K4 flash_bwd_dq",
                                        "K5 flash_bwd_dkv", "K7 flash_bwd_packed"))
    log(f"[kernels] backward at B{TRAIN_B} S{TRAIN_S} H{H} D{D} bf16 causal: "
        f"K3 {k3['ms']:.4f} ms ({k3['tflops']:.0f} TFLOP/s on 10 D per pair; "
        f"its dq_finish_kernel "
        f"{k3['finish_ms']:.4f} ms), "
        f"K7 {k7['ms']:.4f} ms, K4 + K5 {k4['ms']:.4f} + {k5['ms']:.4f} = "
        f"{k4['ms'] + k5['ms']:.4f} ms (and the delta pre-pass), SDPA backward "
        f"{k3['library_ms']:.4f} ms, bound {k3['bound_ms']:.4f} ms")
    return rows


def training_kernel_rows(gen, rows: list) -> None:
    """K6 / K7, and K2 / K3 of the "auto" path, at the packed training
    shape, K4 / K5 there and at the long-context shape, each against its
    plain version (same inputs: a packed projection, its forward's O and
    lse, a random upstream gradient)."""
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    cases = [("train", TRAIN_B, TRAIN_S, dt) for dt in (torch.bfloat16, torch.float32)]
    cases += [("long", LONG_B, LONG_S, dt) for dt in (torch.bfloat16, torch.float32)]
    for case, b, s, dtype in cases:
        e = H * D
        qkv = torch.randn(b, s, 3 * e, generator=gen, device="cuda").to(dtype)
        do = torch.randn(b, s, e, generator=gen, device="cuda").to(dtype)
        q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(e, dim=-1))
        do4 = do.unflatten(-1, (H, D))
        shape = dict(case=case, B=b, S=s)
        label = dtype_label(dtype)
        itm = dtype.itemsize
        bse, rows_f32 = b * s * e * itm, b * H * s * 4
        pairs = b * H * s * (s + 1) // 2  # causal (query, key) pairs
        timed = []
        if case == "train":
            kern = lambda: fa.flash_attention_packed_fwd(qkv, H, causal=True)
            plain = lambda: fa.flash_attention_packed_reference(qkv, H, causal=True)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)
            (o, lse), want = kern(), plain()
            check_close(rows, "K6 flash_fwd_packed", {"o": o, "lse": lse},
                        dict(zip(("o", "lse"), want)), label, **shape)
            fwd_lib_ms = time_ms(lib)
            timed.append((kern, plain, fwd_lib_ms,
                          bound(4 * bse + rows_f32, 4 * D * pairs, dtype), 4 * D * pairs))
            kern = lambda: fa.flash_attention_packed_bwd(qkv, o, do, lse, H, causal=True)
            plain = lambda: fa.flash_attention_packed_bwd_reference(
                qkv, o, do, lse, H, causal=True)
            # dqkv held as its three column ranges: dq, dk, dv apart.
            split = lambda t: dict(zip(("dq", "dk", "dv"), t.split(e, dim=-1)))
            got, want = (split(f()) for f in (kern, plain))
            check_close(rows, "K7 flash_bwd_packed", got, want, label, **shape)
            check_bitwise_repeat(rows, got, split(kern()), f"K7 {shape} {label}")
            sdpa_ms = sdpa_bwd_ms(q, k, v, do4)
            timed.append((kern, plain, sdpa_ms,
                          bound(8 * bse + rows_f32, 10 * D * pairs + 2 * b * s * e, dtype),
                          14 * D * pairs))
            # K2, the forward the trainer's "auto" path runs, on the strided
            # q / k / v views of the same projection (batch stride 3E): o
            # and lse apart. Its O and lse feed K3, K4 and K5 below, as the
            # trainer's forward gives them to its backward.
            kern = lambda: fa.flash_attention_fwd(q, k, v, causal=True)
            plain = lambda: fa.flash_attention_reference(q, k, v, causal=True)
            (o4, lse4), want = kern(), plain()
            check_close(rows, "K2 flash_fwd", {"o": o4, "lse": lse4},
                        dict(zip(("o", "lse"), want)), label, **shape)
            timed.append((kern, plain, fwd_lib_ms,
                          bound(4 * bse + rows_f32, 4 * D * pairs, dtype), 4 * D * pairs))
            # K3, the one-block backward the trainer's "auto" path runs, on
            # K2's output: dq, dk, dv apart.
            args3 = (q, k, v, o4, do4, lse4)
            kern = lambda: fa.flash_attention_bwd_fused(*args3, causal=True)
            plain = lambda: fa.flash_attention_bwd_fused_reference(*args3, causal=True)
            got, want = (dict(zip(("dq", "dk", "dv"), f())) for f in (kern, plain))
            check_close(rows, "K3 flash_bwd_fused", got, want, label, **shape)
            # dQ's partials are summed in a fixed order: a second run on
            # the same inputs gives every output bit for bit.
            check_bitwise_repeat(rows, got, dict(zip(("dq", "dk", "dv"), kern())),
                                 f"K3 {shape} {label}")
            timed.append((kern, plain, sdpa_ms,
                          bound(8 * bse + rows_f32, 10 * D * pairs + 2 * b * s * e, dtype),
                          10 * D * pairs))
            k3_split(rows[-1], args3, dtype)
        else:
            o4, lse4 = fa.flash_attention_fwd(q, k, v, causal=True)
        delta = fa.flash_bwd_delta(o4, do4)
        args = (q, k, v, do4, lse4, delta)
        kern = lambda: fa.flash_bwd_dq(*args, causal=True)
        plain = lambda: fa.flash_bwd_dq_reference(*args, causal=True)
        got = {"dq": kern()}
        check_close(rows, "K4 flash_bwd_dq", got, {"dq": plain()}, label, **shape)
        check_bitwise_repeat(rows, got, {"dq": kern()}, f"K4 {shape} {label}")
        lib_ms = sdpa_bwd_ms(q, k, v, do4)  # dQ, dK and dV together
        timed.append((kern, plain, lib_ms,
                      bound(5 * bse + 2 * rows_f32, 6 * D * pairs, dtype), 6 * D * pairs))
        kern = lambda: fa.flash_bwd_dkv(*args, causal=True)
        plain = lambda: fa.flash_bwd_dkv_reference(*args, causal=True)
        got, want = (dict(zip(("dk", "dv"), f())) for f in (kern, plain))
        check_close(rows, "K5 flash_bwd_dkv", got, want, label, **shape)
        check_bitwise_repeat(rows, got, dict(zip(("dk", "dv"), kern())),
                             f"K5 {shape} {label}")
        timed.append((kern, plain, lib_ms,
                      bound(6 * bse + 2 * rows_f32, 8 * D * pairs, dtype), 8 * D * pairs))
        torch.cuda.synchronize()
        for row, (kern, plain, lib_ms, (bms, by), *flops) in zip(rows[-len(timed):], timed):
            row.update(ms=time_ms(kern), plain_ms=time_ms(plain, reps=5),
                       library_ms=lib_ms, bound_ms=bms, bound_us=bms * 1e3,
                       bound_by=by)
            if flops:  # the products' operations per causal pair: K2 / K6 4 D,
                tflops(row, flops[0])  # K3 10 D, K4 6 D, K5 8 D, K7 14 D
            log(json.dumps(row))
        del qkv, do, q, k, v, do4, o4, lse4, delta, args
        torch.cuda.empty_cache()
    k3_edge_rows(gen, rows)
    k3_d128_row(gen, rows)


def device_ms_by_kernel(fn, names, reps: int = 10) -> dict:
    """Device time per call of each kernel whose name contains one of
    `names`, from torch.profiler over `reps` calls of `fn`, the L2 flushed
    before each (as time_ms flushes it)."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        for n in names:
            if n in e.key:
                out[n] += e.self_device_time_total / 1e3 / reps
    return out


def k3_split(row: dict, args3: tuple, dtype) -> None:
    """K3's call on the trainer shape's inputs taken apart, into the K3
    row: its two launches' times (the pass over the pairs and
    dq_finish_kernel, by torch.profiler), the partial-dQ workspace and the
    peak of memory the call allocates above what was allocated before it."""
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    from ray_tpu_torch.ops import _kernels

    lib = _kernels.library("flash_bwd_fused", fa._FUSED_ARGTYPES)
    b, s, h, d = args3[0].shape
    call = lambda: fa.flash_attention_bwd_fused(*args3, causal=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    split = device_ms_by_kernel(call, ("flash_bwd_fused_mma_kernel",
                                       "fused_bwd_f32_kernel", "dq_finish_kernel"))
    rows_ws = lib.flash_bwd_fused_workspace_rows(s, 1, _kernels.dtype_code(dtype))
    row.update(pairs_kernel_ms=split["flash_bwd_fused_mma_kernel"]
               + split["fused_bwd_f32_kernel"],
               finish_ms=split["dq_finish_kernel"],
               workspace_mib=b * h * rows_ws * d * 4 / 2**20, call_peak_mib=peak)


def k3_d128_row(gen, rows: list) -> None:
    """K3 at head_dim 128 (B8 S1024 H6, bf16 causal: the trainer's width
    in half the heads), against its plain version and timed, on strided
    q / k / v views and K2's O and lse."""
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    b, s, h, d, dtype = TRAIN_B, TRAIN_S, 6, 128, torch.bfloat16
    e = h * d
    qkv = torch.randn(b, s, 3 * e, generator=gen, device="cuda").to(dtype)
    q, k, v = (t.unflatten(-1, (h, d)) for t in qkv.split(e, dim=-1))
    do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    args = (q, k, v, o, do, lse)
    kern = lambda: fa.flash_attention_bwd_fused(*args, causal=True)
    plain = lambda: fa.flash_attention_bwd_fused_reference(*args, causal=True)
    got, want = (dict(zip(("dq", "dk", "dv"), f())) for f in (kern, plain))
    check_close(rows, "K3 flash_bwd_fused", got, want, dtype_label(dtype),
                case="d128", B=b, S=s, H=h, D=d)
    check_bitwise_repeat(rows, got, dict(zip(("dq", "dk", "dv"), kern())),
                         f"K3 D{d} {dtype_label(dtype)}")
    pairs = b * h * s * (s + 1) // 2
    bse = b * s * e * dtype.itemsize
    bms, by = bound(8 * bse + b * h * s * 4, 10 * d * pairs + 2 * b * s * e, dtype)
    rows[-1].update(ms=time_ms(kern), plain_ms=time_ms(plain, reps=5),
                    library_ms=sdpa_bwd_ms(q, k, v, do), bound_ms=bms,
                    bound_us=bms * 1e3, bound_by=by)
    tflops(rows[-1], 10 * d * pairs)
    log(json.dumps(rows[-1]))
    del qkv, q, k, v, do, o, lse, args, got, want
    torch.cuda.empty_cache()


def k3_edge_rows(gen, rows: list) -> None:
    """K3 against its plain version where its tiles end early: B2 S1000
    (1000 is not a multiple of the 64-row key tile) and non-causal at
    S256, bf16; dq, dk, dv apart."""
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    for b, s, causal in ((2, 1000, True), (2, 256, False)):
        dtype, e = torch.bfloat16, H * D
        qkv = torch.randn(b, s, 3 * e, generator=gen, device="cuda").to(dtype)
        q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(e, dim=-1))
        do = torch.randn(b, s, H, D, generator=gen, device="cuda").to(dtype)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        args = (q, k, v, o, do, lse)
        got, want = (dict(zip(("dq", "dk", "dv"), f(*args, causal=causal)))
                     for f in (fa.flash_attention_bwd_fused,
                               fa.flash_attention_bwd_fused_reference))
        check_close(rows, "K3 flash_bwd_fused", got, want, dtype_label(dtype),
                    case="tail" if causal else "full", B=b, S=s)
        log(json.dumps(rows[-1]))


def phase_profile(rows: list) -> dict:
    """The three profiling entry points at their default shape, each with
    its kernel's launch counter set to 0 just before and read just after
    (K8 by attn_dissect, K9 by attn_variants, K10 by attn_subtile); then
    every K8 level and the two-head variant, every K9 tile and every K10 T
    held against its plain version under LIMITS."""
    from ray_tpu_torch.ops import attn_profile as ap
    from ray_tpu_torch.profiling import attn_dissect, attn_subtile, attn_variants

    t_phase = time.perf_counter()
    launches, profiled = {}, {}
    for name, module, wrapper in (
            ("K8 attn_dissect", attn_dissect, ap.attn_dissect),
            ("K9 flash_fwd_slim", attn_variants, ap.flash_fwd_slim),
            ("K10 attn_subtile", attn_subtile, ap.attn_subtile)):
        wrapper.launches = 0
        t0 = time.perf_counter()
        profiled[name] = module.main([])
        launches[name] = wrapper.launches
        log(f"[profile] {module.__name__}: {time.perf_counter() - t0:.1f}s, "
            f"{name} launched {launches[name]} times")
        for r in profiled[name]:
            log("[profile] " + json.dumps(r))
        if launches[name] == 0:
            fail(f"{module.__name__} did not launch {name}")
    profile_kernel_rows(rows, profiled)
    log(f"[profile] phase {time.perf_counter() - t_phase:.1f}s")
    return {"launches": launches, "rows": profiled}


def profile_kernel_rows(rows: list, profiled: dict) -> None:
    """K8-K10 against their plain versions on one seeded input at the
    entry points' shape, each variant a row: its time is the entry point's
    (`ms`, bound), the plain version's and the library yardstick's are
    timed here. Library: SDPA causal with scale 1 for K8's full softmax
    (level 4, two heads) and K10, SDPA causal for K9; none for K8's levels
    0-3, which are not attention. K8's levels 1-2 are held row by row as
    well (`compare`'s per_row)."""
    from ray_tpu_torch.ops import attn_profile as ap

    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn(PROF_B * H, PROF_S, D, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    # SDPA takes [B, H, S, D] (a 3-D input falls to its unfused math path).
    q4, k4, v4 = (t.unsqueeze(0) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_unscaled = time_ms(lambda: sdpa(q4, k4, v4, is_causal=True, scale=1.0))
    lib_scaled = time_ms(lambda: sdpa(q4, k4, v4, is_causal=True))
    cases = []  # (name, entry row, case, kernel, plain, library ms, per_row)
    for r in profiled["K8 attn_dissect"][1:]:
        lvl, two = r["level"], r["two_heads"]
        cases.append(("K8 attn_dissect", r, "2h" if two else f"L{lvl}",
                      lambda lvl=lvl, two=two: {"o": ap.attn_dissect(q, k, v, lvl, two)},
                      lambda lvl=lvl, two=two: {
                          "o": ap.attn_dissect_reference(q, k, v, lvl, two)},
                      lib_unscaled if lvl == 4 or two else None,
                      lvl in (1, 2) and not two))
    for r in profiled["K9 flash_fwd_slim"][1:]:
        bm, bn = r["block_q"], r["block_k"]
        cases.append(("K9 flash_fwd_slim", r, f"{bm}x{bn}",
                      lambda bm=bm, bn=bn: dict(zip(("o", "lse"), ap.flash_fwd_slim(
                          q, k, v, block_q=bm, block_k=bn))),
                      lambda bn=bn: dict(zip(("o", "lse"), ap.flash_fwd_slim_reference(
                          q, k, v, block_k=bn))),
                      lib_scaled, False))
    for r in profiled["K10 attn_subtile"][1:]:
        t = r["T"]
        cases.append(("K10 attn_subtile", r, f"T{t}",
                      lambda t=t: dict(zip(("o", "lse"), ap.attn_subtile(q, k, v, t))),
                      lambda t=t: dict(zip(("o", "lse"), ap.attn_subtile_reference(
                          q, k, v, t))),
                      lib_unscaled, False))
    for name, r, case, kern, plain, lib_ms, per_row in cases:
        check_close(rows, name, kern(), plain(), "bf16", per_row=per_row,
                    case=case, B=PROF_B, S=PROF_S)
        rows[-1].update(ms=r["ms"], plain_ms=time_ms(plain, reps=3), library_ms=lib_ms,
                        bound_ms=r["bound_ms"], bound_us=r["bound_ms"] * 1e3,
                        bound_by=r["bound_by"], tflops=r["tflops"],
                        current_ms=r["current_ms"])
        log(json.dumps(rows[-1]))
    torch.cuda.empty_cache()


def _train_step(model, opt, state, params, tokens):
    """One training step as the reference's benchmark builds it: forward,
    the shifted-token loss, every parameter's gradient, a fused_adamw
    update (in place). Returns (loss, grads, state)."""
    from ray_tpu_torch.models import cross_entropy_loss

    logits = model(tokens)
    loss = cross_entropy_loss(logits[:, :-1], tokens[:, 1:])
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    _, state = opt.apply(grads, state, params)
    return loss.detach(), grads, state


def _tokens(b, s, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 50257, (b, s), generator=gen, device="cuda")


def _run_steps(model, tokens, steps) -> tuple:
    """`steps` fused_adamw steps on one batch: (losses, step seconds)."""
    from ray_tpu_torch.ops import fused_adamw

    params = dict(model.named_parameters())
    opt = fused_adamw(LR)
    state = opt.init(params)
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, _, state = _train_step(model, opt, state, params, tokens)
        losses.append(loss.item())  # syncs
        times.append(time.perf_counter() - t0)
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    return losses, times, (opt, state, params)


def _rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def phase_train() -> dict:
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models.gpt import GPT, gpt2_125m
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    counters = {
        "K2 flash_fwd": fa.flash_attention_fwd,
        "K4 flash_bwd_dq": fa.flash_bwd_dq,
        "K5 flash_bwd_dkv": fa.flash_bwd_dkv,
        "K6 flash_fwd_packed": fa.flash_attention_packed_fwd,
        "K7 flash_bwd_packed": fa.flash_attention_packed_bwd,
    }

    def zero():
        for f in counters.values():
            f.launches = 0

    def read():
        return {k: f.launches for k, f in counters.items()}

    cfg = gpt2_125m()  # bf16 compute, f32 params, attention_impl="flash"
    model = GPT(cfg, seed=0)
    if any(p.dtype != torch.float32 for p in model.parameters()):
        fail("GPT parameters are not f32 masters")
    tokens = _tokens(TRAIN_B, TRAIN_S)
    layers = cfg.num_layers

    # The main training path: counters from 0, 5 steps, counters read.
    zero()
    losses, times, (opt, state, params) = _run_steps(model, tokens, TRAIN_STEPS)
    launches = read()
    if not losses[-1] < losses[0]:
        fail(f"training loss did not fall on one batch: {losses}")
    for name in ("K6 flash_fwd_packed", "K7 flash_bwd_packed"):
        if launches[name] != layers * TRAIN_STEPS:
            fail(f"{name} launched {launches[name]} times, not {layers} x {TRAIN_STEPS}")
    if any(p.dtype != torch.float32 for p in model.parameters()):
        fail("a parameter left f32 after fused_adamw")
    step_p50 = statistics.median(times)
    summary = {
        "model": "gpt2_125m bf16 (f32 params)", "B": TRAIN_B, "S": TRAIN_S,
        "steps": TRAIN_STEPS, "losses": losses, "step_s": times,
        "step_p50_s": step_p50, "tokens_per_s": TRAIN_B * TRAIN_S / step_p50,
        "launches": dict(launches),
    }
    log("[train] " + json.dumps(summary))

    # Where the time goes: one more step under torch.profiler (the wall is
    # taken inside the profiled block: starting the profiler is not the
    # step's time).
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, state = _train_step(model, opt, state, params, tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                 if e.self_device_time_total > 0}
    busy = sum(device_us.values()) / 1e6
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:8]
    summary.update(profiled_wall_s=wall, device_busy_s=busy, device_busy_share=busy / wall,
                   top_kernels_ms={k[:70]: v / 1e3 for k, v in top})
    log("[train] profiled step: " + json.dumps({
        "wall_s": wall, "device_busy_s": busy, "device_busy_share": busy / wall,
        "top_kernels_ms": summary["top_kernels_ms"],
    }))
    del model, opt, state, params, tokens
    torch.cuda.empty_cache()

    # The long-context branch (S > 2048): K2 forward, K4 / K5 backward.
    long_cfg = gpt2_125m(max_seq_len=LONG_S)
    model = GPT(long_cfg, seed=0)
    tokens = _tokens(LONG_B, LONG_S, seed=1)
    zero()
    losses_l, times_l, _ = _run_steps(model, tokens, LONG_STEPS)
    launches_l = read()
    for name in ("K2 flash_fwd", "K4 flash_bwd_dq", "K5 flash_bwd_dkv"):
        if launches_l[name] != layers * LONG_STEPS:
            fail(f"long context: {name} launched {launches_l[name]} times, "
                 f"not {layers} x {LONG_STEPS}")
    summary["long"] = {
        "B": LONG_B, "S": LONG_S, "steps": LONG_STEPS, "losses": losses_l,
        "step_s": times_l, "tokens_per_s": LONG_B * LONG_S / statistics.median(times_l),
        "launches": dict(launches_l),
    }
    log("[train] long context: " + json.dumps(summary["long"]))
    del model, tokens
    torch.cuda.empty_cache()

    summary["parity"] = [
        _f32_parity(gpt2_125m(dtype=torch.float32), PARITY_B, PARITY_S),
        _f32_parity(gpt2_125m(dtype=torch.float32, max_seq_len=LONG_S,
                              num_layers=PARITY_LONG_LAYERS), 1, LONG_S),
    ]
    summary["launches_main"] = {"K6 flash_fwd_packed": launches["K6 flash_fwd_packed"],
                                "K7 flash_bwd_packed": launches["K7 flash_bwd_packed"],
                                "K4 flash_bwd_dq": launches_l["K4 flash_bwd_dq"],
                                "K5 flash_bwd_dkv": launches_l["K5 flash_bwd_dkv"]}
    return summary


def _f32_parity(cfg, b, s) -> dict:
    """One f32 step through the kernels and through attention_impl=
    'reference' on the same weights and batch: the loss within 1e-5
    relative, every gradient within 1e-4 relative L2, and after a
    fused_adamw step every parameter within 1e-4 relative L2. Adam's first
    update is lr * g / (|g| + eps), a step of ±lr whose sign is the
    gradient's. Where |g| is below the two sides' gradient difference,
    rounding alone can flip that sign, so elements whose plain gradient is
    below GRAD_FLOOR are left out of the parameter check: among them the key
    third of each qkv bias, whose exact gradient is zero (q·b_k cancels in
    the softmax). The floor lies above the largest gradient difference
    measured on the H100 (8.0e-8); how many elements it leaves out, the
    leaf it takes most from, and the largest gradient difference of this
    run are printed."""
    import dataclasses

    from ray_tpu_torch.models.gpt import GPT
    from ray_tpu_torch.ops import fused_adamw

    kern = GPT(cfg, seed=0)
    plain = GPT(dataclasses.replace(cfg, attention_impl="reference"), seed=0)
    plain.load_state_dict(kern.state_dict())
    tokens = _tokens(b, s, seed=2)
    out = {}
    for label, model in (("kernels", kern), ("plain", plain)):
        params = dict(model.named_parameters())
        opt = fused_adamw(LR)
        loss, grads, _ = _train_step(model, opt, opt.init(params), params, tokens)
        out[label] = (loss.item(), grads, params)
        del grads
    (lk, gk, pk), (lp, gp, pp) = out["kernels"], out["plain"]
    loss_rel = abs(lk - lp) / abs(lp)
    grad_rel = {n: _rel_l2(gk[n], gp[n]) for n in gk}
    grad_diff = max((gk[n] - gp[n]).abs().max().item() for n in gk)
    param_rel, left_out, dropped_g = {}, {}, 0.0
    for n in pk:
        keep = gp[n].abs() >= GRAD_FLOOR
        param_rel[n] = _rel_l2(pk[n].detach()[keep], pp[n].detach()[keep])
        left_out[n] = int((~keep).sum())
        if left_out[n]:
            dropped_g = max(dropped_g, gp[n][~keep].abs().max().item())
    most_out = max(left_out, key=lambda n: left_out[n] / pk[n].numel())
    worst_g = max(grad_rel, key=grad_rel.get)
    worst_p = max(param_rel, key=param_rel.get)
    res = {"layers": cfg.num_layers, "B": b, "S": s, "loss_kernels": lk,
           "loss_plain": lp, "loss_rel": loss_rel, "grad_rel_max": grad_rel[worst_g],
           "grad_worst": worst_g, "grad_abs_diff_max": grad_diff,
           "param_rel_max": param_rel[worst_p], "param_worst": worst_p,
           "param_elements": sum(p.numel() for p in pk.values()),
           "left_out": sum(left_out.values()), "left_out_grad_max": dropped_g,
           "left_out_most": most_out,
           "left_out_most_share": left_out[most_out] / pk[most_out].numel()}
    log("[train] f32 parity: " + json.dumps(res))
    if not loss_rel <= 1e-5:
        fail(f"f32 loss: kernels {lk} vs plain {lp}")
    if not grad_rel[worst_g] <= 1e-4:
        fail(f"f32 gradient of {worst_g}: relative L2 {grad_rel[worst_g]}")
    if not param_rel[worst_p] <= 1e-4:
        fail(f"f32 parameter {worst_p} after the step: relative L2 {param_rel[worst_p]}")
    del kern, plain, out
    torch.cuda.empty_cache()
    return res


def _fingerprint(parts: dict) -> dict:
    """Per leaf of each part ({part: {name: tensor}}), computed where the
    tensor lies: its dtype, its float64 sum and a position-weighted sum of
    its bytes. A checkpoint that drops, casts, reorders or stales a value
    changes it."""
    out = {}
    for part, leaves in parts.items():
        for name, t in leaves.items():
            t = t.detach().contiguous()
            raw = t.view(-1).view(torch.uint8).to(torch.int64)
            weight = torch.arange(raw.numel(), device=raw.device) % 65521 + 1
            out[f"{part}/{name}"] = [str(t.dtype), t.double().sum().item(),
                                     (raw * weight).sum().item()]
    return out


def _trainer_loop(config):
    """The train loop of the trainer phase, run by TorchTrainer in its worker
    actor: GPT-2 125M (bf16 compute, f32 params, attention_impl="auto") on
    the worker's device, `config["steps"]` fused_adamw steps on one seeded
    batch through prepare_params / prepare_batch / prepare_step. Resumed
    from a checkpoint, it restores the parameters and both moments, checks
    them bit for bit against the checkpoint, and reports their fingerprint
    on the device (`_fingerprint`). Each step reports its loss and time; the
    step `config["profile_step"]` runs under torch.profiler; the last step
    reports the fingerprint of the live parameters and moments, and a
    checkpoint of them (on the host)."""
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch import train
    from ray_tpu_torch.air import Checkpoint
    from ray_tpu_torch.models.gpt import GPT, gpt2_125m
    from ray_tpu_torch.ops import FusedAdamWState, fused_adamw

    t_setup = time.perf_counter()
    device = train.get_device()
    model = GPT(gpt2_125m(attention_impl="auto"), device=device, seed=0)
    params = dict(model.named_parameters())
    opt = fused_adamw(LR)
    state = opt.init(params)
    restored = restored_fp = None
    saved = train.get_checkpoint()
    if saved is not None:
        saved = saved.to_dict()
        with torch.no_grad():
            for name, value in train.prepare_params(saved["params"]).items():
                params[name].copy_(value)
        state = FusedAdamWState(count=saved["count"].clone(),
                                mu=train.prepare_params(saved["mu"]),
                                nu=train.prepare_params(saved["nu"]))
        restored = all(
            torch.equal(live[k].detach().cpu(), saved[part][k])
            for part, live in (("params", params), ("mu", state.mu), ("nu", state.nu))
            for k in params
        )
        restored_fp = _fingerprint({"params": params, "mu": state.mu, "nu": state.nu})
    start = int(state.count)
    gen = torch.Generator().manual_seed(0)
    tokens = train.prepare_batch(
        torch.randint(0, 50257, (TRAIN_B, TRAIN_S), generator=gen))
    opt_state = {"state": state}
    torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_setup

    def step():
        loss, _, opt_state["state"] = _train_step(model, opt, opt_state["state"],
                                                  params, tokens)
        return loss

    step = train.prepare_step(step)
    last = start + config["steps"] - 1
    for i in range(start, last + 1):
        metrics = {"step": i, "restored_bit_for_bit": restored,
                   "restored_fingerprint": restored_fp if i == start else None,
                   "setup_s": setup_s}
        if i == config.get("profile_step"):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                loss = step()
                torch.cuda.synchronize(device)
                wall = time.perf_counter() - t0
            device_us = {e.key: e.self_device_time_total for e in prof.key_averages()
                         if e.self_device_time_total > 0}
            top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
            metrics["profile"] = {
                "wall_s": wall, "device_busy_s": sum(device_us.values()) / 1e6,
                "top_kernels_ms": {k[:70]: v / 1e3 for k, v in top}}
        else:
            t0 = time.perf_counter()
            loss = step()  # bounded by torch.cuda.synchronize (instrumented)
            wall = time.perf_counter() - t0
        metrics.update(loss=loss.item(), step_s=wall)
        ckpt = None
        if i == last:
            t_ckpt = time.perf_counter()
            state = opt_state["state"]
            metrics["fingerprint"] = _fingerprint(
                {"params": params, "mu": state.mu, "nu": state.nu})
            ckpt = Checkpoint.from_dict({
                "params": {k: p.detach().cpu() for k, p in params.items()},
                "mu": {k: m.cpu() for k, m in state.mu.items()},
                "nu": {k: m.cpu() for k, m in state.nu.items()},
                "count": state.count.clone(),
            })
            metrics["checkpoint_s"] = time.perf_counter() - t_ckpt
        train.report(metrics, checkpoint=ckpt)


def phase_trainer() -> dict:
    """GPT-2 125M through ray_tpu_torch.train.TorchTrainer: init the
    in-process runtime, fit() 5 steps on a worker actor on cuda:0 with the
    launch counters zeroed just before and read just after (K2 and K3 12 per
    step, K4-K7 none) and the peak of allocated device memory over them, then a second fit() resuming from the first's
    checkpoint for one step (its own counts), then f32 parity of one
    attention_impl="auto" step against "reference"."""
    import ray_tpu_torch
    from ray_tpu_torch.models.gpt import gpt2_125m
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

    counters = {
        "K2 flash_fwd": fa.flash_attention_fwd,
        "K3 flash_bwd_fused": fa.flash_attention_bwd_fused,
        "K4 flash_bwd_dq": fa.flash_bwd_dq,
        "K5 flash_bwd_dkv": fa.flash_bwd_dkv,
        "K6 flash_fwd_packed": fa.flash_attention_packed_fwd,
        "K7 flash_bwd_packed": fa.flash_attention_packed_bwd,
    }
    layers = gpt2_125m().num_layers

    def fit(steps, checkpoint=None, profile_step=None):
        trainer = TorchTrainer(
            _trainer_loop,
            train_loop_config={"steps": steps, "profile_step": profile_step},
            scaling_config=ScalingConfig(num_workers=1),
            resume_from_checkpoint=checkpoint,
        )
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        result = trainer.fit()
        wall = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counters.items()}
        if result.error is not None:
            fail(f"TorchTrainer.fit() failed: {result.error!r}")
        history = result.metrics_history
        want = {k: (layers * steps if k in ("K2 flash_fwd", "K3 flash_bwd_fused") else 0)
                for k in counters}
        if launches != want:
            fail(f"trainer launches {launches}, not {want}")
        losses = [m["loss"] for m in history]
        if len(losses) != steps or not all(np.isfinite(losses)):
            fail(f"trainer losses {losses}")
        return result, wall, launches

    ray_tpu_torch.init()
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        result, wall, launches = fit(TRAIN_STEPS, profile_step=TRAIN_STEPS - 1)
        peak_mib = torch.cuda.max_memory_allocated() / 2**20
        history = result.metrics_history
        losses = [m["loss"] for m in history]
        if not losses[-1] < losses[0]:
            fail(f"trainer loss did not fall on one batch: {losses}")
        times = [m["step_s"] for m in history]
        step_p50 = statistics.median(times[:-1])  # the last step is profiled
        prof = history[-1]["profile"]
        summary = {
            "model": "gpt2_125m bf16 (f32 params), attention_impl=auto",
            "B": TRAIN_B, "S": TRAIN_S, "steps": TRAIN_STEPS, "losses": losses,
            "step_s": times, "step_p50_s": step_p50,
            "tokens_per_s": TRAIN_B * TRAIN_S / step_p50,
            "fit_wall_s": wall, "fit_overhead_s": wall - sum(times),
            "loop_setup_s": history[0]["setup_s"],
            "checkpoint_to_host_s": history[-1]["checkpoint_s"],
            "profiled_step": {**prof, "device_busy_share": prof["device_busy_s"] / prof["wall_s"]},
            "launches": launches, "peak_alloc_mib": peak_mib,
        }
        log("[trainer] " + json.dumps(summary))
        resumed, wall_r, launches_r = fit(1, checkpoint=result.checkpoint)
        last = resumed.metrics_history[-1]
        if last["step"] != TRAIN_STEPS or last["restored_bit_for_bit"] is not True:
            fail(f"resumed fit: step {last['step']}, restored "
                 f"{last['restored_bit_for_bit']}")
        # The live state's fingerprint before the checkpoint left the card,
        # against the restored state's on the card, leaf by leaf.
        saved_fp = history[-1]["fingerprint"]
        restored_fp = last["restored_fingerprint"]
        if not saved_fp or restored_fp != saved_fp:
            bad = sorted(k for k in saved_fp
                         if (restored_fp or {}).get(k) != saved_fp[k])
            fail(f"resumed fit: {len(bad)} of {len(saved_fp)} restored leaves "
                 f"differ from the saved state, first {bad[:3]}")
        summary["resumed"] = {"step": last["step"], "loss": last["loss"],
                              "restored_bit_for_bit": True,
                              "fingerprint_leaves": len(saved_fp), "fit_wall_s": wall_r,
                              "loop_setup_s": last["setup_s"],
                              "launches": launches_r}
        log("[trainer] resumed: " + json.dumps(summary["resumed"]))
    finally:
        ray_tpu_torch.shutdown()
    torch.cuda.empty_cache()
    summary["parity"] = _f32_parity(
        gpt2_125m(dtype=torch.float32, attention_impl="auto"), PARITY_B, PARITY_S)
    return summary


def _prompts(rng) -> list:
    """8 prompts: one long enough (~600) for chunked prefill, two sharing
    a 64-token prefix, one repeated block-aligned prompt (prefix cache hit
    on the whole prompt, so its last block is copied on write), and mixed
    lengths."""
    vocab = 50257
    shared = list(rng.randint(0, vocab, 64))
    repeated = list(rng.randint(0, vocab, 96))
    return [
        list(rng.randint(0, vocab, 600)),
        shared + list(rng.randint(0, vocab, 40)),
        shared + list(rng.randint(0, vocab, 77)),
        repeated,
        repeated,
        list(rng.randint(0, vocab, 9)),
        list(rng.randint(0, vocab, 150)),
        list(rng.randint(0, vocab, 333)),
    ]


def _engine_config():
    from ray_tpu_torch.llm import EngineConfig

    return EngineConfig(block_size=16, num_blocks=1024, max_decode_slots=16,
                        max_blocks_per_seq=64)


def _concurrent(server, prompts, n_new) -> tuple:
    """Every prompt from its own thread through generate_stream: (token
    lists, client-side TTFTs, wall seconds until the card is idle)."""
    results = [None] * len(prompts)
    ttft = [None] * len(prompts)

    def client(i):
        t_sub = time.perf_counter()
        toks = []
        for tok in server.generate_stream(prompts[i], max_new_tokens=n_new):
            if not toks:
                ttft[i] = time.perf_counter() - t_sub
            toks.append(tok)
        results[i] = toks

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    return results, ttft, time.perf_counter() - t0


def _sequential(server, prompts, n_new) -> list:
    return [server.generate(p, max_new_tokens=n_new)["token_ids"] for p in prompts]


def _free(*servers) -> None:
    for s in servers:
        s.shutdown()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_server() -> dict:
    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.models.gpt import gpt2_125m
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
    from ray_tpu_torch.ops.paged_flash import paged_flash_attention

    n_new = 32
    prompts = _prompts(np.random.RandomState(0))
    t0 = time.perf_counter()
    server = LLMServer(gpt2_125m(), _engine_config(), seed=0)
    log(f"[server] bf16 GPT-2 125M up in {time.perf_counter() - t0:.1f}s "
        f"(init + warmup), kv pools {server.metrics()['kv_pool_bytes'] / 1e6:.0f} MB x2")

    # The main path: counters from 0, 8 concurrent requests, counters read.
    paged_flash_attention.launches = 0
    flash_attention_fwd.launches = 0
    results, ttft, wall = _concurrent(server, prompts, n_new)
    launches = {
        "K1 paged_attention": paged_flash_attention.launches,
        "K2 flash_fwd": flash_attention_fwd.launches,
    }
    m = server.metrics()
    steps = [r["duration_s"] for r in server.flight_record()["steps"]]
    if any(r is None or len(r) != n_new for r in results):
        fail(f"not every request finished with {n_new} tokens: "
             f"{[None if r is None else len(r) for r in results]}")
    if m["prefix_cache_hit_tokens"] <= 0:
        fail("prefix cache never hit")
    for name, n in launches.items():
        if n <= 0:
            fail(f"{name} was not launched on the main path")
    summary = {
        "requests": len(prompts),
        "tokens": n_new * len(prompts),
        "wall_s": wall,
        "tokens_per_s": n_new * len(prompts) / wall,
        "ttft_p50_s": statistics.median(ttft),
        "step_p50_s": statistics.median(steps),
        "steps": m["steps"],
        "prefix_cache_hit_tokens": m["prefix_cache_hit_tokens"],
        "cow_blocks": m["cow_blocks"],
        "chunked_prefill_requests": m["chunked_prefill_requests"],
        "launches": launches,
        "launches_per_request": {k: v / len(prompts) for k, v in launches.items()},
    }
    log("[server] " + json.dumps(summary))

    # Where the time goes: the same traffic again (prefix cache reset, so
    # the same programs run) under torch.profiler: the card's busy share of
    # the wall time, and the kernels that fill it.
    from torch.profiler import ProfilerActivity, profile

    server.reset_prefix_cache()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, wall_p = _concurrent(server, prompts, n_new)
    device_us = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            device_us[e.key] = e.self_device_time_total
    busy_s = sum(device_us.values()) / 1e6
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
    summary["profiled_wall_s"] = wall_p
    summary["device_busy_share"] = busy_s / wall_p
    summary["top_kernels_ms"] = {k[:60]: v / 1e3 for k, v in top}
    log("[server] profiled: " + json.dumps({
        "wall_s": wall_p, "device_busy_s": busy_s,
        "device_busy_share": busy_s / wall_p,
        "top_kernels_ms": summary["top_kernels_ms"],
    }))

    # bf16: agreement with the plain path (reported, not asserted: the
    # kernel prescales q in bf16, the reference scales f32 logits).
    server.reset_prefix_cache()
    got = _sequential(server, prompts, n_new)
    weights = server.engine.runner.model.state_dict()
    plain = LLMServer(gpt2_125m(attention_impl="reference"), _replace_attn(),
                      params=weights)
    want = _sequential(plain, prompts, n_new)
    _free(server, plain)
    agree = np.mean([a == b for x, y in zip(got, want) for a, b in zip(x, y)])
    log(f"[server] bf16 kernel vs plain-path token agreement: {agree:.4f}")
    summary["bf16_agreement"] = float(agree)

    # f32: token-identical to the plain path on the same weights, first
    # through the servers one request at a time, then with all 8 requests
    # live together in one deterministic batch (the engine's own generate,
    # once the servers' loops have stopped): per-slot tables, idle lanes'
    # null-block scatters, chunked prefill beside decode, CoW under load.
    f32 = LLMServer(gpt2_125m(dtype=torch.float32), _engine_config(), seed=0)
    weights = f32.engine.runner.model.state_dict()
    f32_plain = LLMServer(gpt2_125m(dtype=torch.float32, attention_impl="reference"),
                          _replace_attn(), params=weights)
    runs = {"one at a time": (_sequential(f32, prompts, n_new),
                              _sequential(f32_plain, prompts, n_new))}
    for s in (f32, f32_plain):
        s.shutdown()
        s.engine.allocator.reset_prefix_cache()
    runs["batched"] = tuple(s.engine.generate(prompts, max_new_tokens=n_new)
                            for s in (f32, f32_plain))
    live = max(r["batch_size"]
               for r in f32.engine.flight_recorder.snapshot()["steps"])
    _free(f32, f32_plain)
    for label, (got, want) in runs.items():
        if any(len(r) != n_new for r in got) or got != want:
            bad = [i for i, (x, y) in enumerate(zip(got, want)) if x != y]
            fail(f"f32 kernel path ({label}) differs from the plain path on "
                 f"requests {bad}")
    if live < len(prompts):
        fail(f"the batched f32 run decoded at most {live} slots at once")
    log("[server] f32 kernel path token-identical to the plain path "
        f"({len(prompts)} requests x {n_new} tokens, one at a time and "
        f"batched with up to {live} decode slots live)")
    summary["f32_batched_live_slots"] = live
    return summary


def _replace_attn():
    import dataclasses

    return dataclasses.replace(_engine_config(), attn_impl="reference")


KERNELS = {
    "K1 paged_attention": dict(
        route="cuda", source="ray_tpu_torch/ops/csrc/paged_attention.cu",
        replaces="ray_tpu/ops/paged_flash.py:108",
        main=dict(case="decode", dtype="bf16"),
    ),
    "K2 flash_fwd": dict(
        route="cuda", source="ray_tpu_torch/ops/csrc/flash_fwd.cu",
        replaces="ray_tpu/ops/flash_attention.py:66",
        main=dict(case="prefill", S=256, dtype="bf16"),
    ),
    "K3 flash_bwd_fused": dict(
        route="cuda", source="ray_tpu_torch/ops/csrc/flash_bwd_fused.cu",
        replaces="ray_tpu/ops/flash_attention.py:288",
        main=dict(case="train", dtype="bf16"),
    ),
    "K4 flash_bwd_dq": dict(
        route="cuda", source="ray_tpu_torch/ops/csrc/flash_bwd.cu",
        replaces="ray_tpu/ops/flash_attention.py:194",
        main=dict(case="long", dtype="bf16"),
    ),
    "K5 flash_bwd_dkv": dict(
        route="cuda", source="ray_tpu_torch/ops/csrc/flash_bwd.cu",
        replaces="ray_tpu/ops/flash_attention.py:238",
        main=dict(case="long", dtype="bf16"),
    ),
    "K6 flash_fwd_packed": dict(
        route="cuda", source="ray_tpu_torch/ops/csrc/flash_fwd.cu",
        replaces="ray_tpu/ops/flash_attention.py:443",
        main=dict(case="train", dtype="bf16"),
    ),
    "K7 flash_bwd_packed": dict(
        route="cuda", source="ray_tpu_torch/ops/csrc/flash_bwd.cu",
        replaces="ray_tpu/ops/flash_attention.py:473",
        main=dict(case="train", dtype="bf16"),
    ),
    "K8 attn_dissect": dict(
        route="cuda", source="ray_tpu_torch/ops/csrc/attn_dissect.cu",
        replaces="benchmarks/profile_attn_dissect.py:17",
        main=dict(case="L4", dtype="bf16"),
    ),
    "K9 flash_fwd_slim": dict(
        route="cuda", source="ray_tpu_torch/ops/csrc/attn_slim.cu",
        replaces="benchmarks/profile_attn_variants.py:27",
        main=dict(case="64x64", dtype="bf16"),
    ),
    "K10 attn_subtile": dict(
        route="cuda", source="ray_tpu_torch/ops/csrc/attn_subtile.cu",
        replaces="benchmarks/profile_attn_subtile.py:21",
        main=dict(case="T4", dtype="bf16"),
    ),
}


def kernels_line(rows: list, launches: dict) -> dict:
    out = []
    for name, meta in KERNELS.items():
        row = next(r for r in rows if r["kernel"] == name
                   and all(r.get(k) == v for k, v in meta["main"].items()))
        out.append({
            "name": name, "route": meta["route"], "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows if r["kernel"] == name),
            # K8's levels 1-2 carry the -1e30 mask into outputs of ~1e31, so
            # its absolute error is read beside the relative one.
            "max_rel_l2": max(o["rel_l2"] for r in rows if r["kernel"] == name
                              for o in r["outputs"].values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "shape": {k: row[k] for k in ("case", "B", "S", "dtype")},
        })
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    device = phase_device()
    phase_build()
    rows = phase_kernels()
    profile = phase_profile(rows)
    launches = dict(phase_train()["launches_main"])
    trainer = phase_trainer()
    launches["K3 flash_bwd_fused"] = trainer["launches"]["K3 flash_bwd_fused"]
    launches.update(phase_server()["launches"])
    launches.update(profile["launches"])
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(kernels_line(rows, launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["name"],
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
