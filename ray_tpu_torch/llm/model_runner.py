"""Prefill / decode step programs over the paged KV cache (PyTorch).

The same step programs as the reference runner, at tensor-parallel degree
1: one decode program over a fixed [max_decode_slots] batch and a fixed
block-table width, a full-prefill program per power-of-two bucket, a
*partial*-prefill program per bucket (prefix caching and the continuation
chunks of chunked prefill: feed only the uncached suffix at a position
offset and attend the cached prefix through the block table), and a
block-to-block copy (copy-on-write for shared blocks). PyTorch runs eagerly,
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

    # ---------------- decode ----------------

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
        bs = self.engine_config.block_size
        b = tokens.shape[0]
        block_idx = block_tables[np.arange(b), positions // bs]
        offsets = positions % bs
        tokens_d, pos_d, tables_d, lens_d, blk_d, off_d = self._to_device(
            tokens, positions, block_tables, context_lens, block_idx, offsets,
        )
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
        return self._to_host(torch.argmax(logits[:, 0, :], dim=-1))
