"""Prefill / decode step programs over the paged KV cache (PyTorch).

The same step programs as the reference runner, at tensor-parallel degree
1: one decode program over a fixed [max_decode_slots] batch and a fixed
block-table width, a full-prefill program per power-of-two bucket, a
*partial*-prefill program per bucket (prefix caching and the continuation
chunks of chunked prefill: feed only the uncached suffix at a position
offset and attend the cached prefix through the block table), a
block-to-block copy (copy-on-write for shared blocks), and — with
speculative decoding on — a batched k-token verify program per fed width
bucket (the partial-prefill shape over [max_decode_slots] slots, returning
the argmax at EVERY fed position). `decode_async` dispatches the decode
program without waiting for it (the async step loop). PyTorch runs eagerly,
so nothing compiles; the fixed shapes still bound the kernels' launch
shapes, which the server's warmup touches before traffic.

The cache pools are [L, num_blocks, block_size, H, D] device tensors (int8
pools add [L, N, bs, H] scale tensors) updated IN PLACE with index_put_,
where the reference threads them functionally through donated buffers.
Every attention call of a step reads the pools before any of that step's
new K/V is written (the model returns each layer's K/V and the runner
scatters them after the forward), which is the reference's semantics: its
program reads the pools as they stood before the step. Padded lanes and
idle slots write to the null block 0, which nothing reads unmasked. The
argmax runs on the device over the model-dtype logits; only the sampled
token ids cross to the host.

Serving hot-path knobs (EngineConfig):

  * ``attn_impl`` — the decode / partial-prefill programs read the cache
    through the CUDA kernel (``ops.paged_flash``) or the gather + softmax
    reference; "auto" resolves once at construction from the device.
  * ``kv_cache_dtype`` — "int8" stores the pools quantized with per-token
    per-head scale tensors (scales ride every scatter and block copy);
    dequantization is fused into the attention kernel.

The KV fabric's two copies, `extract_block` and `restore_block`, move one
block's content across every layer between the pools and host numpy
arrays, one copy each way per block.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.llm.cache import kv_pool_bytes_sharded
from ray_tpu_torch.llm.config import EngineConfig
from ray_tpu_torch.models.gpt import GPT, GPTConfig
from ray_tpu_torch.ops.paged_flash import (
    KV_SCALE_DTYPE,
    quantize_kv,
    resolve_paged_impl,
)


class GPTRunner:
    """Owns the model weights, the paged cache pools, and the step programs."""

    def __init__(
        self,
        model_config: GPTConfig,
        engine_config: EngineConfig,
        params: Optional[Mapping[str, object]] = None,
        seed: int = 0,
        device=None,
    ):
        if engine_config.max_model_len > model_config.max_seq_len:
            raise ValueError(
                f"cache capacity {engine_config.max_model_len} tokens/seq "
                f"exceeds model max_seq_len {model_config.max_seq_len}"
            )
        if engine_config.tensor_parallel_size != 1:
            raise NotImplementedError(
                "tensor_parallel_size > 1 is not ported yet (ROADMAP: the "
                "tp=2 over NCCL slice)"
            )
        self.device = resolve_device(device)
        self.model_config = model_config
        self.engine_config = engine_config
        self.tensor_parallel_size = 1
        # Resolved once from the device: every step program uses it.
        self.attn_impl = resolve_paged_impl(engine_config.attn_impl, self.device)
        self.kv_cache_dtype = {
            "auto": model_config.dtype,
            "bf16": torch.bfloat16,
            "int8": torch.int8,
        }[engine_config.kv_cache_dtype]
        self.quantized = self.kv_cache_dtype == torch.int8
        # What the pools actually store, in the knob's vocabulary.
        self.kv_cache_dtype_str = {
            torch.bfloat16: "bf16", torch.int8: "int8"
        }.get(self.kv_cache_dtype, str(self.kv_cache_dtype).replace("torch.", ""))

        self.model = GPT(model_config, device=self.device, seed=seed)
        if params is not None:
            self.model.load_state_dict(
                {k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
                 for k, v in params.items()}
            )
        self.model.requires_grad_(False)
        self.model.eval()
        # Serving never updates the weights: one copy cast to the compute
        # dtype (per-use casts of the f32 masters cost the server's decode
        # step ~70% on an H100, PERF.md).
        self.model.cast_for_inference()
        # Parameter count (the tied head counted once): feeds the fleet
        # ledger's MFU estimate — decode FLOPs ~= 2 * num_params per token.
        self.num_params = int(sum(p.numel() for p in self.model.parameters()))
        # Host-transfer accounting: bytes explicitly moved across the
        # host/device boundary by the step programs (token ids, block
        # tables, lengths in; sampled token ids out).
        self.host_bytes_in = 0
        self.host_bytes_out = 0
        # decode_async's pinned staging ring (CUDA only; buffers made at
        # first use): per slot, the packed inputs, the event fencing their
        # copy, and the host buffer the sampled tokens land in.
        self._ring = [
            {"in": None, "in_event": None, "out": None} for _ in range(3)
        ]
        self._ring_at = 0

        cfg, ecfg = model_config, engine_config
        cache_shape = (
            cfg.num_layers, ecfg.num_blocks, ecfg.block_size,
            cfg.num_heads, cfg.head_dim,
        )
        zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=self.device)
        self.k_cache = zeros(cache_shape, self.kv_cache_dtype)
        self.v_cache = zeros(cache_shape, self.kv_cache_dtype)
        if self.quantized:
            scale_shape = cache_shape[:-1]  # [L, N, bs, H]
            self.k_scale = zeros(scale_shape, KV_SCALE_DTYPE)
            self.v_scale = zeros(scale_shape, KV_SCALE_DTYPE)
        else:
            self.k_scale = None
            self.v_scale = None

    # ---------------- plumbing ----------------

    def _to_device(self, *arrays: np.ndarray) -> Tuple[torch.Tensor, ...]:
        self.host_bytes_in += sum(int(a.nbytes) for a in arrays)
        return tuple(
            torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)
            for a in arrays
        )

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        out = t.to(torch.int32).cpu().numpy()
        self.host_bytes_out += int(out.nbytes)
        return out

    def _store_kv(self, new_kv: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """New-token K or V [..., H, D] → (pool-dtype values, per-token
        scales or None). int8 pools quantize at scatter time."""
        if self.quantized:
            return quantize_kv(new_kv)
        return new_kv.to(self.kv_cache_dtype), None

    def _scatter(self, kvs, index: Tuple[torch.Tensor, ...], shape=None) -> None:
        """Write each layer's new K/V (and scales) into the pools at
        `index` (block ids, or block ids + offsets), in place. Duplicate
        indices only ever address the null block."""
        for layer, (k, v) in enumerate(kvs):
            kq, ks = self._store_kv(k)
            vq, vs = self._store_kv(v)
            if shape is not None:
                kq, vq = kq.reshape(shape), vq.reshape(shape)
                if ks is not None:
                    ks, vs = ks.reshape(shape[:-1]), vs.reshape(shape[:-1])
            self.k_cache[layer].index_put_(index, kq)
            self.v_cache[layer].index_put_(index, vq)
            if ks is not None:
                self.k_scale[layer].index_put_(index, ks)
                self.v_scale[layer].index_put_(index, vs)

    def host_transfer_bytes(self) -> int:
        """Cumulative explicit host<->device bytes across all step
        programs (inputs fed + sampled tokens fetched)."""
        return self.host_bytes_in + self.host_bytes_out

    def kv_pool_bytes(self) -> dict:
        """Aggregate and per-shard bytes of both KV pools (+ scale tensors
        when quantized)."""
        cfg, ecfg = self.model_config, self.engine_config
        return kv_pool_bytes_sharded(
            cfg.num_layers, ecfg.num_blocks, ecfg.block_size,
            cfg.num_heads, cfg.head_dim,
            self.kv_cache_dtype.itemsize,
            KV_SCALE_DTYPE.itemsize if self.quantized else None,
            tensor_parallel_size=1,
        )

    def kv_block_bytes(self) -> int:
        """Bytes of ONE block's payload (K + V values across every layer,
        plus scale tensors when quantized)."""
        cfg, ecfg = self.model_config, self.engine_config
        slots = cfg.num_layers * ecfg.block_size * cfg.num_heads
        nbytes = 2 * slots * cfg.head_dim * self.kv_cache_dtype.itemsize
        if self.quantized:
            nbytes += 2 * slots * KV_SCALE_DTYPE.itemsize
        return nbytes

    # ---------------- KV fabric spill / restore ----------------

    def _block_pools(self):
        """(payload key, pool) for every pool a block's content lives in."""
        pools = [("k", self.k_cache), ("v", self.v_cache)]
        if self.quantized:
            pools += [("k_scale", self.k_scale), ("v_scale", self.v_scale)]
        return pools

    @torch.no_grad()
    def extract_block(self, block: int) -> dict:
        """Read one block's content (every layer) into host numpy — the
        spill half of the fabric tier. The payload holds the pools' own
        values (+ int8 scales), so restore is bit-exact; `kv_dtype` stamps
        the storage format so a mismatched engine treats the entry as a
        miss instead of scattering garbage.

        numpy has no bfloat16, so a bfloat16 pool (and the int8 pools'
        bfloat16 scales) is stored as its int16 bit pattern: the same two
        bytes an element, which `restore_block` views back. The block's
        pieces are gathered into one device buffer and cross to the host
        in one blocking copy, which orders it after every write already
        queued on the stream. The copy lands in a buffer numpy owns: the
        arrays share memory neither with the pools (on the CPU too, so a
        slot reused later cannot change an extracted payload) nor with any
        torch tensor, which a payload held in the store past the
        interpreter's teardown would otherwise free too late."""
        pools = self._block_pools()
        gathered = torch.cat(
            [p[:, block].reshape(-1).view(torch.uint8) for _, p in pools]
        )
        flat = np.empty(gathered.numel(), np.uint8)
        torch.from_numpy(flat).copy_(gathered)
        payload = {"kv_dtype": self.kv_cache_dtype_str}
        at = 0
        for key, p in pools:
            shape = p.shape[:1] + p.shape[2:]
            n = p[:, block].numel() * p.element_size()
            payload[key] = (
                flat[at : at + n].view(_host_dtype(p.dtype)).reshape(shape)
            )
            at += n
        self.host_bytes_out += at
        return payload

    @torch.no_grad()
    def restore_block(self, block: int, payload: dict) -> None:
        """Write one spilled payload back into slot `block` — the restore
        half, one host-to-device copy. Raises ValueError on a
        storage-format mismatch (different kv_cache_dtype or block shape);
        the caller then treats the chain as a fabric miss and the slot
        stays a prefill target."""
        if payload.get("kv_dtype") != self.kv_cache_dtype_str:
            raise ValueError(
                f"fabric payload stored as {payload.get('kv_dtype')!r}, "
                f"pool is {self.kv_cache_dtype_str!r} — engines on one "
                "fabric must share kv_cache_dtype"
            )
        expected = tuple(self.k_cache.shape[:1] + self.k_cache.shape[2:])
        if tuple(payload["k"].shape) != expected:
            raise ValueError(
                f"fabric payload block shape {tuple(payload['k'].shape)} "
                f"does not match pool block shape {expected}"
            )
        pools = self._block_pools()
        arrays = []
        for key, p in pools:
            a = np.ascontiguousarray(payload[key])
            want = _host_dtype(p.dtype)
            if a.dtype != want or a.shape != p.shape[:1] + p.shape[2:]:
                raise ValueError(
                    f"fabric payload {key!r} is {a.dtype}{list(a.shape)}, "
                    f"pool block is {want}{list(p.shape[:1] + p.shape[2:])}"
                )
            arrays.append(a.reshape(-1).view(np.uint8))
        dev = torch.from_numpy(np.concatenate(arrays)).to(self.device)
        at = 0
        for (key, p), a in zip(pools, arrays):
            piece = dev[at : at + a.size].view(p.dtype)
            p[:, block] = piece.view(p.shape[:1] + p.shape[2:])
            at += a.size
        self.host_bytes_in += at

    def _paged_caches(self, block_tables, context_lens):
        return (self.k_cache, self.v_cache, block_tables, context_lens,
                self.k_scale, self.v_scale)

    # ---------------- prefill ----------------

    @torch.no_grad()
    def prefill(self, token_ids: Sequence[int], block_ids: Sequence[int]) -> int:
        """Run one prompt through the model, scatter its K/V into the given
        blocks, and return the greedily-sampled next token."""
        ecfg, cfg = self.engine_config, self.model_config
        n = len(token_ids)
        bucket = ecfg.bucket_for(n)
        nb = bucket // ecfg.block_size
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :n] = token_ids
        # Bucket padding beyond the sequence's own blocks scatters into the
        # null block; it is garbage that nothing ever reads unmasked.
        blocks = np.zeros((nb,), np.int32)
        blocks[: len(block_ids)] = block_ids
        tokens_d, blocks_d = self._to_device(tokens, blocks)
        logits, kvs = self.model(tokens_d, return_kv=True)
        paged = (nb, ecfg.block_size, cfg.num_heads, cfg.head_dim)
        self._scatter(
            [(k[0], v[0]) for k, v in kvs], (blocks_d.long(),), shape=paged
        )
        return int(self._to_host(torch.argmax(logits[0, n - 1, :]))[()])

    # ---------------- partial prefill (prefix caching) ----------------

    @torch.no_grad()
    def prefill_suffix(
        self, token_ids: Sequence[int], block_ids: Sequence[int], offset: int
    ) -> int:
        """Prefix-aware prefill: run only the uncached suffix of a prompt
        whose first `offset` tokens already sit in the paged cache (through
        `block_ids`, the sequence's whole block table), scatter the suffix
        K/V, and return the greedily-sampled next token."""
        ecfg = self.engine_config
        n = len(token_ids)
        bucket = ecfg.bucket_for(n)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :n] = token_ids
        table = np.zeros((ecfg.max_blocks_per_seq,), np.int32)
        table[: len(block_ids)] = block_ids
        lane = np.arange(bucket)
        valid = lane < n
        positions = np.where(valid, offset + lane, 0)
        bs = ecfg.block_size
        block_idx = np.where(valid, table[positions // bs], 0)
        offsets = np.where(valid, positions % bs, 0)
        tokens_d, table_d, lens_d, pos_d, blk_d, off_d = self._to_device(
            tokens, table, np.array([offset], np.int32), positions, block_idx,
            offsets,
        )
        logits, kvs = self.model(
            tokens_d,
            positions=pos_d[None, :],
            paged_caches=self._paged_caches(table_d[None, :], lens_d),
            paged_impl=self.attn_impl,
            return_kv=True,
        )
        self._scatter(
            [(k[0], v[0]) for k, v in kvs], (blk_d.long(), off_d.long())
        )
        return int(self._to_host(torch.argmax(logits[0, n - 1, :]))[()])

    @torch.no_grad()
    def copy_block(self, src: int, dst: int) -> None:
        """Device-copy one block's K/V (and scales) across every layer
        (copy-on-write before a sequence writes into a shared block)."""
        for pool in (self.k_cache, self.v_cache, self.k_scale, self.v_scale):
            if pool is not None:
                pool[:, dst] = pool[:, src]
        self.host_bytes_in += 8  # two int32 block ids

    # ---------------- decode / k-token verification ----------------

    @torch.no_grad()
    def verify(
        self,
        tokens: np.ndarray,
        block_tables: np.ndarray,
        context_lens: np.ndarray,
        true_lens: np.ndarray,
    ) -> np.ndarray:
        """Batched multi-token scoring for speculative decoding. tokens
        [B, S] = each slot's last committed token followed by its proposed
        tokens (0-padded past true_lens[b]); block_tables [B, nb];
        context_lens [B] = committed K/V per slot; true_lens [B] = fed
        tokens per slot (1 + that slot's proposals) → out [B, S], the
        argmax after consuming fed tokens 0..i of each slot. Arrays must
        already be padded to [max_decode_slots, S_bucket] /
        [max_decode_slots, max_blocks_per_seq] / [max_decode_slots]; the
        S buckets are EngineConfig.verify_buckets.

        The partial-prefill shape batched over slots: slot b's fed tokens
        sit at absolute positions context_lens[b] + lane, attend the
        committed prefix through the block table (paged) and each other
        causally, and their K/V is scattered at those positions — so
        out[b, i] is exactly the token the plain decode loop would have
        produced there. Padded lanes (lane >= true_lens[b]) get position 0
        and block 0 (the null block) and their outputs are garbage the
        engine never reads. int8 caveat: lanes attend EACH OTHER through
        their fresh full-precision K/V while sequential decode reads the
        same tokens back quantized, so under kv_cache_dtype="int8" the
        equivalence holds within quantization (int8's own contract)."""
        bs = self.engine_config.block_size
        b, s = tokens.shape
        lane = np.arange(s)[None, :]
        valid = lane < true_lens[:, None]
        positions = np.where(valid, context_lens[:, None] + lane, 0)
        block_idx = np.where(
            valid, block_tables[np.arange(b)[:, None], positions // bs], 0
        )
        offsets = np.where(valid, positions % bs, 0)
        tokens_d, tables_d, lens_d, pos_d, blk_d, off_d = self._to_device(
            tokens, block_tables, context_lens, positions, block_idx, offsets,
        )
        logits, kvs = self.model(
            tokens_d,
            positions=pos_d,
            paged_caches=self._paged_caches(tables_d, lens_d),
            paged_impl=self.attn_impl,
            return_kv=True,
        )
        self._scatter(kvs, (blk_d.long(), off_d.long()))
        return self._to_host(torch.argmax(logits, dim=-1))

    def _decode_program(
        self, tokens_d, pos_d, tables_d, lens_d, blk_d, off_d
    ) -> torch.Tensor:
        """The decode step on device inputs → next_tokens [B] (int64, on
        the device). `tokens_d` is only read: under async scheduling it is
        the previous step's output."""
        logits, kvs = self.model(
            tokens_d[:, None],
            positions=pos_d[:, None],
            paged_caches=self._paged_caches(tables_d, lens_d),
            paged_impl=self.attn_impl,
            return_kv=True,
        )
        self._scatter(
            [(k[:, 0], v[:, 0]) for k, v in kvs],
            (blk_d.long(), off_d.long()),
        )
        return torch.argmax(logits[:, 0, :], dim=-1)

    def _decode_index(self, positions: np.ndarray, block_tables: np.ndarray):
        """Each slot's scatter target (block id, offset) for its write at
        `positions`; idle slots carry an all-null table, so block 0."""
        bs = self.engine_config.block_size
        b = positions.shape[0]
        return block_tables[np.arange(b), positions // bs], positions % bs

    @torch.no_grad()
    def decode(
        self,
        tokens: np.ndarray,
        positions: np.ndarray,
        block_tables: np.ndarray,
        context_lens: np.ndarray,
    ) -> np.ndarray:
        """Batched single-token decode; arrays must already be padded to
        [max_decode_slots] / [max_decode_slots, max_blocks_per_seq]. Idle
        slots carry an all-null block table, so they write to block 0."""
        block_idx, offsets = self._decode_index(positions, block_tables)
        next_tokens = self._decode_program(*self._to_device(
            tokens, positions, block_tables, context_lens, block_idx, offsets,
        ))
        return self._to_host(next_tokens)

    @torch.no_grad()
    def decode_async(
        self,
        tokens,
        positions: np.ndarray,
        block_tables: np.ndarray,
        context_lens: np.ndarray,
    ) -> "DeviceTokens":
        """Dispatch one batched decode WITHOUT waiting for its result.

        The same step program as `decode`, but the sampled tokens stay on
        the device: `tokens` may be the previous step's `DeviceTokens`
        (token chaining — its tensor is only read, never written, so the
        caller can still fetch it afterwards), and the return value holds
        THIS step's token tensor with its device-to-host copy already
        queued. The caller materializes the values one step later with
        `DeviceTokens.fetch()` at commit time.

        On a CUDA device nothing here waits for the stream: the host-side
        inputs are packed into a pinned staging buffer and copied with
        `non_blocking=True`, and the sampled tokens land in a pinned host
        buffer fenced by a CUDA event. The engine refills its numpy input
        buffers every step, so the staging buffers are this runner's own
        (a ring; one is refilled only after its previous copy has left
        it). On the CPU the step runs synchronously; the engine's logic is
        the same."""
        chained = isinstance(tokens, DeviceTokens)
        block_idx, offsets = self._decode_index(positions, block_tables)
        # Chained token inputs never cross the host boundary — that is
        # part of the win the transfer counters should show.
        host_in = (positions, block_tables, context_lens, block_idx, offsets)
        if not chained:
            host_in = (tokens,) + host_in
        slot = None
        if self.device.type == "cuda":
            slot = self._ring_at
            self._ring_at = (slot + 1) % len(self._ring)
            inputs = self._stage(host_in, slot)
        else:
            inputs = self._to_device(*host_in)
        if chained:
            inputs = (tokens.tensor,) + inputs
        return self._start_fetch(self._decode_program(*inputs), slot)

    # ---------------- async transfers (CUDA) ----------------

    def _stage(self, arrays, slot: int) -> Tuple[torch.Tensor, ...]:
        """Copy int32 host arrays to the device without a stream
        synchronise: packed into the ring slot's pinned buffer (each
        segment 16-byte aligned, as the kernels require of their inputs)
        and sent by one non-blocking copy. The slot's event, recorded after
        that copy, is waited on before the buffer is refilled — normally
        long past, since the ring is deeper than the engine's in-flight
        depth of 2."""
        self.host_bytes_in += sum(int(a.nbytes) for a in arrays)
        spans = [-(-int(a.size) // 4) * 4 for a in arrays]
        total = sum(spans)
        ring = self._ring[slot]
        if ring["in"] is None or ring["in"].numel() < total:
            ring["in"] = torch.empty(total, dtype=torch.int32, pin_memory=True)
        elif ring["in_event"] is not None and not ring["in_event"].query():
            ring["in_event"].synchronize()
        view = ring["in"].numpy()
        at = 0
        for a, span in zip(arrays, spans):
            view[at : at + a.size] = a.reshape(-1)
            at += span
        dev = ring["in"][:total].to(self.device, non_blocking=True)
        ring["in_event"] = torch.cuda.Event()
        ring["in_event"].record()
        out, at = [], 0
        for a, span in zip(arrays, spans):
            out.append(dev[at : at + a.size].view(a.shape))
            at += span
        return tuple(out)

    def _start_fetch(self, next_tokens: torch.Tensor, slot) -> "DeviceTokens":
        """Queue the sampled tokens' copy into the ring slot's pinned host
        buffer, fenced by an event (slot None: on the CPU, where they are
        on the host already). The slot's previous tokens were fetched at
        their commit, which precedes this dispatch by at least a step."""
        self.host_bytes_out += next_tokens.numel() * 4  # int32 on the host
        if slot is None:
            return DeviceTokens(next_tokens, next_tokens.to(torch.int32).numpy(), None)
        ring = self._ring[slot]
        if ring["out"] is None or ring["out"].numel() != next_tokens.numel():
            ring["out"] = torch.empty(
                next_tokens.numel(), dtype=torch.int32, pin_memory=True
            )
        # A new int32 tensor: the chained input itself is never written.
        ring["out"].copy_(next_tokens.to(torch.int32), non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return DeviceTokens(next_tokens, ring["out"], event)


def _host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a pool of `dtype` is stored as on the host:
    bfloat16, which numpy lacks, as its int16 bit pattern."""
    if dtype == torch.bfloat16:
        return np.dtype(np.int16)
    return torch.empty((), dtype=dtype).numpy().dtype


class DeviceTokens:
    """One async decode step's sampled tokens: the device tensor (the next
    chained step's input), the host buffer its copy lands in, and the CUDA
    event fencing that copy (None on the CPU, where the values are already
    on the host)."""

    __slots__ = ("tensor", "host", "event")

    def __init__(self, tensor: torch.Tensor, host, event) -> None:
        self.tensor = tensor
        self.host = host
        self.event = event

    def pending(self) -> bool:
        """Whether the step (and its copy) is still running on the card."""
        return self.event is not None and not self.event.query()

    def fetch(self) -> np.ndarray:
        """The sampled tokens as int32 numpy, waiting on this step's event
        only (not on the whole device)."""
        if self.event is None:
            return self.host
        self.event.synchronize()
        return self.host.numpy().copy()
