#!/usr/bin/env python3
"""On-card smoke test of ray_tpu_torch, the PyTorch / CUDA port.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device  — the card's name and power limit (nvidia-smi) and torch's name;
  2. build   — compile every CUDA kernel from ray_tpu_torch/ops/csrc;
  3. kernels — hold each kernel against its plain PyTorch version at the
     serving path's GPT-2 125M shapes (H=12, D=64), with stated
     tolerances; time kernel, plain version and, where one PyTorch call
     computes the same function, that call (a yardstick only);
  4. server  — LLMServer serves GPT-2 125M (random seeded weights) to 8
     concurrent requests; asserts they all finish, the prefix cache hit,
     and both kernels launched on that run; then f32 on the kernels must
     be token-identical to f32 on the plain versions, one request at a
     time through the servers and all 8 live together in one batch.
The last two lines are the kernels JSON and the {"ok": true, ...} contract.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, per type
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
H, D, BS, NB = 12, 64, 16, 64  # GPT-2 125M heads/width; the server's cache
REPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# ---------------------------------------------------------------- timing

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
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: {info['seconds']:.1f}s")
        for ln in ptxas:
            log(f"[build]   {ln}")
    log(f"[build] total {time.perf_counter() - t0:.1f}s "
        f"({len(report)} compiled, {len(_kernels.KERNELS) - len(report)} cached)")


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
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = TOL[dtype]
            rows.append(dict(
                kernel="K1 paged_attention", case=label, B=b, S=s, dtype=kv,
                ctx_max=max(ctx), max_abs_err=err, tol=tol,
            ))
            if not err <= tol:
                fail(f"K1 {label} {kv}: max_abs_err {err} > {tol}")
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
    for s in (128, 256, 1024):
        for dtype in (torch.bfloat16, torch.float32):
            qkv = torch.randn(1, s, 3 * H * D, generator=gen, device="cuda").to(dtype)
            q, k, v = (t.view(1, s, H, D) for t in qkv.split(H * D, dim=-1))
            kern = lambda: flash_attention_fwd(q, k, v, causal=True)
            plain = lambda: flash_attention_reference(q, k, v, causal=True)
            (o, lse), (o_ref, lse_ref) = kern(), plain()
            torch.cuda.synchronize()
            err = max(
                (o.float() - o_ref.float()).abs().max().item(),
                (lse - lse_ref).abs().max().item(),
            )
            tol = TOL[dtype]
            name = "bf16" if dtype == torch.bfloat16 else "f32"
            rows.append(dict(
                kernel="K2 flash_fwd", case="prefill", B=1, S=s, dtype=name,
                max_abs_err=err, tol=tol,
            ))
            if not err <= tol:
                fail(f"K2 S={s} {name}: max_abs_err {err} > {tol}")
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library = lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True
            )
            ms, plain_ms = time_ms(kern), time_ms(plain, reps=10)
            lib_ms = time_ms(library)
            nbytes = 4 * s * H * D * dtype.itemsize + H * s * 4
            bms, by = bound(nbytes, 4 * D * H * s * (s + 1) // 2, dtype)
            rows[-1].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bms, bound_us=bms * 1e3, bound_by=by)
            log(json.dumps(rows[-1]))
    return rows


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
    try:
        import ray_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the repository root ({exc})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    device = phase_device()
    phase_build()
    rows = phase_kernels()
    launches = phase_server()["launches"]
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(kernels_line(rows, launches)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["name"],
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
