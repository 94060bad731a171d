"""Prefill / decode step programs over the paged KV cache (PyTorch).

The same step programs as the reference runner: one decode program over a
fixed [max_decode_slots] batch and a fixed block-table width, a
full-prefill program per power-of-two bucket, a *partial*-prefill program
per bucket (prefix caching and the continuation chunks of chunked prefill:
feed only the uncached suffix at a position offset and attend the cached
prefix through the block table), a block-to-block copy (copy-on-write for
shared blocks), and — with speculative decoding on — a batched k-token
verify program per fed width bucket (the partial-prefill shape over
[max_decode_slots] slots, returning the argmax at EVERY fed position).
`decode_async` dispatches the decode program without waiting for it (the
async step loop). PyTorch runs eagerly, so nothing compiles; the fixed
shapes still bound the kernels' launch shapes, which the server's warmup
touches before traffic.

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
  * ``tensor_parallel_size`` — > 1 runs every program on a group of that
    many processes, one per device (``parallel.tensor_parallel_group``):
    this runner is rank 0, the others run ``llm.tp_worker``'s loop. Each
    rank holds its slice of the weights (``parallel.LLM_TP_RULES``) and its
    own pools [L, N, bs, H/tp, D] (scales [L, N, bs, H/tp]), so block ids
    mean the same on every rank and the allocator, the scheduler and the
    host buffers stay with rank 0. A program first does everything on the
    host that can raise, then sends every rank a header (which program,
    its shapes) and its inputs as one broadcast from rank 0's device; each
    rank runs the program on its shard, with one all-reduce after
    ``attn_proj`` and one after ``mlp_out`` in every block and no
    all-gather. Only rank 0 computes the logits and fetches tokens, so
    ``host_transfer_bytes`` is the same series at every tp. An exception
    inside a program, on any rank, ends the group (TensorParallelError):
    the ranks could no longer be sure to meet in the same collective.
    Rank 0 waits on its device only through the group's fence
    (`_fence`), so a rank that dies inside a program raises
    TensorParallelError too, instead of blocking the next copy to the host.

The KV fabric's two copies, `extract_block` and `restore_block`, move one
block's content across every layer between the pools and host numpy
arrays, one copy each way per block. Under tensor parallelism rank 0
gathers the other ranks' heads for an extract and broadcasts a restore,
whose ranks each keep their heads: a payload has the same bytes at every
tp, so engines of different tp share one fabric.
"""

from __future__ import annotations

import contextlib
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.llm.cache import kv_pool_bytes_sharded
from ray_tpu_torch.llm.config import EngineConfig
from ray_tpu_torch.models.gpt import GPT, GPTConfig
from ray_tpu_torch.ops.attention import validate_tp_heads
from ray_tpu_torch.ops.paged_flash import (
    KV_SCALE_DTYPE,
    quantize_kv,
    resolve_paged_impl,
)
from ray_tpu_torch.parallel.sharding import (
    LLM_POOL_SPEC,
    full_numel,
    llm_pool_shape,
    llm_shard_params,
)

# The step programs a header names (llm.tp_worker runs them on the other
# ranks). decode_async runs DECODE there: the workers never sample.
PREFILL, PREFILL_SUFFIX, DECODE, VERIFY, COPY_BLOCK, EXTRACT_BLOCK, RESTORE_BLOCK = range(1, 8)


def program_shapes(program: int, dims: Sequence[int]) -> list:
    """The int32 inputs of a model program, in order, from its header's
    dims — rank 0 packs them in this order and the workers unpack them."""
    if program == PREFILL:
        bucket, nb = dims[:2]
        return [(1, bucket), (nb,)]
    if program == PREFILL_SUFFIX:
        bucket, mb = dims[:2]
        return [(1, bucket), (mb,), (1,), (bucket,), (bucket,), (bucket,)]
    if program == DECODE:
        b, mb = dims[:2]
        return [(b,), (b,), (b, mb), (b,), (b,), (b,)]
    if program == VERIFY:
        b, s, mb = dims[:3]
        return [(b, s), (b, mb), (b,), (b, s), (b, s), (b, s)]
    raise ValueError(f"unknown step program {program}")


def _spans(shapes) -> list:
    """Each input's int32 span in a packed buffer: rounded up to 4 ints, so
    every segment starts 16-byte aligned, as the kernels require."""
    return [-(-int(np.prod(s, dtype=np.int64)) // 4) * 4 for s in shapes]


def _pack(arrays, out: np.ndarray) -> np.ndarray:
    """int32 host arrays into `out`, laid out by `_spans`."""
    spans = _spans([a.shape for a in arrays])
    at = 0
    for a, span in zip(arrays, spans):
        out[at : at + a.size] = a.reshape(-1)
        at += span
    return out


def _views(dev: torch.Tensor, shapes) -> Tuple[torch.Tensor, ...]:
    out, at = [], 0
    for shape, span in zip(shapes, _spans(shapes)):
        n = int(np.prod(shape, dtype=np.int64))
        out.append(dev[at : at + n].view(shape))
        at += span
    return tuple(out)


class GPTRunner:
    """Owns the model weights, the paged cache pools, and the step programs.

    With ``tensor_parallel_size > 1`` the runner is one rank of
    `tp_group`, which the caller owns: the engine makes one group for its
    target and draft runners, and a worker passes its own. `params` are the
    full weights (sliced here per rank) unless `params_are_shard` (a
    worker's runner, handed its slice)."""

    def __init__(
        self,
        model_config: GPTConfig,
        engine_config: EngineConfig,
        params: Optional[Mapping[str, object]] = None,
        seed: int = 0,
        device=None,
        tp_group=None,
        params_are_shard: bool = False,
    ):
        if engine_config.max_model_len > model_config.max_seq_len:
            raise ValueError(
                f"cache capacity {engine_config.max_model_len} tokens/seq "
                f"exceeds model max_seq_len {model_config.max_seq_len}"
            )
        tp = engine_config.tensor_parallel_size
        validate_tp_heads(model_config.num_heads, tp)
        self.device = resolve_device(device)
        self.model_config = model_config
        self.engine_config = engine_config
        self.tensor_parallel_size = tp
        if tp > 1 and tp_group is None:
            raise ValueError(
                f"tensor_parallel_size {tp} needs a tp_group "
                "(parallel.tensor_parallel_group; LLMEngine makes one)"
            )
        if tp_group is not None and tp_group.size != tp:
            raise ValueError(
                f"tp_group has {tp_group.size} ranks, engine_config asks for "
                f"tensor_parallel_size {tp}"
            )
        self._tp = tp_group if tp > 1 else None
        self.tp_rank = tp_group.rank if self._tp is not None else 0
        self._slot = None
        self._closed = False
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

        state = None
        if params is not None:
            state = {
                k: v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
                for k, v in params.items()
            }
        if self._tp is not None and self.tp_rank == 0:
            # Every other rank builds its shard first, from its slice of
            # the weights or from the seed (full, then sliced).
            self._slot = self._tp.add_runner(lambda r: dict(
                model_config=model_config, engine_config=engine_config,
                params=None if state is None else llm_shard_params(state, r, tp),
                seed=seed,
            ))
        try:
            self.model = GPT(model_config, device=self.device, seed=seed,
                             group=self._tp, init=state is None)
            if state is not None:
                if self._tp is not None and not params_are_shard:
                    state = llm_shard_params(state, self.tp_rank, tp)
                self.model.load_state_dict(state)
        except BaseException:
            self.close()
            raise
        self.model.requires_grad_(False)
        self.model.eval()
        # Serving never updates the weights: one copy cast to the compute
        # dtype (per-use casts of the f32 masters cost the server's decode
        # step ~70% on an H100, PERF.md).
        self.model.cast_for_inference()
        # Parameter count of the whole model (the tied head counted once,
        # every rank's slice counted): feeds the fleet ledger's MFU
        # estimate — decode FLOPs ~= 2 * num_params per token.
        self.num_params = int(sum(
            full_numel(name, p.numel(), tp) for name, p in self.model.named_parameters()
        ))
        # Host-transfer accounting: bytes explicitly moved across the
        # host/device boundary by the step programs (token ids, block
        # tables, lengths in; sampled token ids out). Rank 0's only.
        self.host_bytes_in = 0
        self.host_bytes_out = 0
        # decode_async's pinned staging ring (CUDA only; buffers made at
        # first use): per slot, the packed inputs, the event fencing their
        # copy, and the host buffer the sampled tokens land in.
        self._ring = [
            {"in": None, "in_event": None, "out": None} for _ in range(3)
        ]
        self._ring_at = 0
        # The synchronous programs' packed inputs (`_upload`), grown as
        # needed.
        self._pack_buf = np.zeros(0, np.int32)

        cfg, ecfg = model_config, engine_config
        # This rank's heads: its pools are tensors of their own (the
        # kernels read contiguous pools), not views of a full pool.
        self.local_heads = cfg.num_heads // tp
        cache_shape = (
            cfg.num_layers, ecfg.num_blocks, ecfg.block_size,
            self.local_heads, cfg.head_dim,
        )
        zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=self.device)
        self.k_cache = zeros(cache_shape, self.kv_cache_dtype)
        self.v_cache = zeros(cache_shape, self.kv_cache_dtype)
        if self.quantized:
            scale_shape = cache_shape[:-1]  # [L, N, bs, H/tp]
            self.k_scale = zeros(scale_shape, KV_SCALE_DTYPE)
            self.v_scale = zeros(scale_shape, KV_SCALE_DTYPE)
        else:
            self.k_scale = None
            self.v_scale = None

    def close(self) -> None:
        """Free the other ranks' shards of this runner. Idempotent; nothing
        to do at tp=1."""
        if self._tp is None or self.tp_rank != 0 or self._closed:
            return
        self._closed = True
        if self._slot is not None and not self._tp.closed:
            self._tp.drop_runner(self._slot)

    # ---------------- plumbing ----------------

    @contextlib.contextmanager
    def _step(self):
        """One program under the group's lock; an exception inside it, after
        the header went out, ends the group (see the module doc)."""
        if self._tp is None:
            yield
            return
        if self._closed:
            raise RuntimeError("GPTRunner is closed")
        with self._tp.lock:
            try:
                yield
            except BaseException as exc:
                from ray_tpu_torch.parallel.mesh import TensorParallelError

                if not isinstance(exc, TensorParallelError):
                    self._tp.fail(f"step program raised on rank 0: {exc!r}")
                raise

    def _send(self, program: int, dims, dev: torch.Tensor, shapes) -> Tuple[torch.Tensor, ...]:
        """Header, then the packed inputs, to every rank; the inputs' views."""
        if self._tp is not None:
            self._tp.dispatch(program, self._slot, dims)
            self._tp.broadcast(dev)
        return _views(dev, shapes)

    def _upload(self, arrays) -> torch.Tensor:
        """int32 host arrays → one packed device buffer (one copy). The
        host side is this runner's own buffer, reused every step: the copy
        out of it (pageable memory) is done when `.to` returns, and on the
        CPU the step that reads it ends before the next one packs."""
        self.host_bytes_in += sum(int(a.nbytes) for a in arrays)
        total = sum(_spans([a.shape for a in arrays]))
        if self._pack_buf.size < total:
            self._pack_buf = np.zeros(total, np.int32)
        self._fence()  # the copy waits on the stream
        return torch.from_numpy(_pack(arrays, self._pack_buf[:total])).to(self.device)

    def _feed(self, program: int, dims, arrays) -> Tuple[torch.Tensor, ...]:
        arrays = [np.ascontiguousarray(a, np.int32) for a in arrays]
        return self._send(program, dims, self._upload(arrays), [a.shape for a in arrays])

    def _fence(self, event=None) -> None:
        """Wait on the host for this rank's stream (up to `event`, or all
        of it). Under tensor parallelism through the group's fence, which
        raises TensorParallelError where a dead rank would block for good
        (parallel.mesh); at tp=1 the event's own wait, if any."""
        if self._tp is not None:
            self._tp.fence(event)
        elif event is not None:
            event.synchronize()

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        self._fence()
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
        programs (inputs fed + sampled tokens fetched), on rank 0."""
        return self.host_bytes_in + self.host_bytes_out

    def kv_pool_bytes(self) -> dict:
        """Aggregate and per-shard bytes of both KV pools (+ scale tensors
        when quantized): each rank holds aggregate / tensor_parallel_size."""
        cfg, ecfg = self.model_config, self.engine_config
        return kv_pool_bytes_sharded(
            cfg.num_layers, ecfg.num_blocks, ecfg.block_size,
            cfg.num_heads, cfg.head_dim,
            self.kv_cache_dtype.itemsize,
            KV_SCALE_DTYPE.itemsize if self.quantized else None,
            tensor_parallel_size=self.tensor_parallel_size,
        )

    def pool_sharding_spec(self) -> Optional[str]:
        """The pools' layout in the reference's words (None at tp=1), read
        off the live tensors: head-split while each rank's K pool holds
        H / tp heads."""
        if self.tensor_parallel_size == 1:
            return None
        cfg, ecfg = self.model_config, self.engine_config
        split = llm_pool_shape(
            cfg.num_layers, ecfg.num_blocks, ecfg.block_size, cfg.num_heads,
            cfg.head_dim, self.tensor_parallel_size,
        )
        if tuple(self.k_cache.shape) == split:
            return LLM_POOL_SPEC
        return f"not head-split: {tuple(self.k_cache.shape)}"

    def kv_block_bytes(self) -> int:
        """Bytes of ONE block's payload (K + V values across every layer,
        plus scale tensors when quantized), over all ranks' heads."""
        cfg, ecfg = self.model_config, self.engine_config
        slots = cfg.num_layers * ecfg.block_size * cfg.num_heads
        nbytes = 2 * slots * cfg.head_dim * self.kv_cache_dtype.itemsize
        if self.quantized:
            nbytes += 2 * slots * KV_SCALE_DTYPE.itemsize
        return nbytes

    # ---------------- worker ranks ----------------

    @torch.no_grad()
    def run_program(self, program: int, dims: Sequence[int]) -> None:
        """Run the program rank 0's header names, on this rank's shard
        (llm.tp_worker's loop)."""
        if program == COPY_BLOCK:
            self._copy_local(dims[0], dims[1])
        elif program == EXTRACT_BLOCK:
            self._tp.gather(self._extract_local(dims[0]))
        elif program == RESTORE_BLOCK:
            dev = torch.empty(dims[1], dtype=torch.uint8, device=self.device)
            self._restore_local(dims[0], self._tp.broadcast(dev))
        else:
            shapes = program_shapes(program, dims)
            dev = torch.empty(sum(_spans(shapes)), dtype=torch.int32, device=self.device)
            inputs = _views(self._tp.broadcast(dev), shapes)
            {
                PREFILL: self._prefill_program,
                PREFILL_SUFFIX: self._suffix_program,
                DECODE: self._decode_program,
                VERIFY: self._verify_program,
            }[program](*inputs)

    # ---------------- KV fabric spill / restore ----------------

    def _block_pools(self):
        """(payload key, pool) for every pool a block's content lives in."""
        pools = [("k", self.k_cache), ("v", self.v_cache)]
        if self.quantized:
            pools += [("k_scale", self.k_scale), ("v_scale", self.v_scale)]
        return pools

    def _block_shape(self, p: torch.Tensor) -> tuple:
        """A payload entry's shape: pool `p`'s block over every rank's
        heads, [L, bs, H(, D)]."""
        return (p.shape[0], p.shape[2], self.model_config.num_heads) + tuple(p.shape[4:])

    def _extract_local(self, block: int) -> torch.Tensor:
        """This rank's heads of one block, every pool, as one uint8 buffer."""
        return torch.cat(
            [p[:, block].reshape(-1).view(torch.uint8) for _, p in self._block_pools()]
        )

    def _assemble(self, parts) -> torch.Tensor:
        """Rank-ordered local buffers → the full-head buffer (per pool,
        the ranks' heads concatenated on the head axis)."""
        out, at = [], 0
        for _, p in self._block_pools():
            n = p[:, 0].numel() * p.element_size()
            local = (p.shape[0], p.shape[2], self.local_heads) + tuple(p.shape[4:])
            pieces = [part[at : at + n].view(p.dtype).view(local) for part in parts]
            out.append(torch.cat(pieces, dim=2).reshape(-1).view(torch.uint8))
            at += n
        return torch.cat(out)

    def _restore_local(self, block: int, dev: torch.Tensor) -> None:
        """Keep this rank's heads of a full-head restore buffer."""
        h0 = self.tp_rank * self.local_heads
        at = 0
        for _, p in self._block_pools():
            full = self._block_shape(p)
            n = int(np.prod(full)) * p.element_size()
            piece = dev[at : at + n].view(p.dtype).view(full)
            p[:, block] = piece[:, :, h0 : h0 + self.local_heads]
            at += n

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
        pieces are gathered into one device buffer (under tensor
        parallelism, every rank's heads) and cross to the host in one
        blocking copy, which orders it after every write already queued on
        the stream. The copy lands in a buffer numpy owns: the arrays
        share memory neither with the pools (on the CPU too, so a slot
        reused later cannot change an extracted payload) nor with any
        torch tensor, which a payload held in the store past the
        interpreter's teardown would otherwise free too late."""
        with self._step():
            if self._tp is not None:
                self._tp.dispatch(EXTRACT_BLOCK, self._slot, (block,))
                gathered = self._assemble(self._tp.gather(self._extract_local(block)))
            else:
                gathered = self._extract_local(block)
            flat = np.empty(gathered.numel(), np.uint8)
            self._fence()
            torch.from_numpy(flat).copy_(gathered)
        payload = {"kv_dtype": self.kv_cache_dtype_str}
        at = 0
        for key, p in self._block_pools():
            shape = self._block_shape(p)
            n = int(np.prod(shape)) * p.element_size()
            payload[key] = flat[at : at + n].view(_host_dtype(p.dtype)).reshape(shape)
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
        expected = self._block_shape(self.k_cache)
        if tuple(payload["k"].shape) != expected:
            raise ValueError(
                f"fabric payload block shape {tuple(payload['k'].shape)} "
                f"does not match pool block shape {expected}"
            )
        arrays = []
        for key, p in self._block_pools():
            a = np.ascontiguousarray(payload[key])
            want, shape = _host_dtype(p.dtype), self._block_shape(p)
            if a.dtype != want or a.shape != shape:
                raise ValueError(
                    f"fabric payload {key!r} is {a.dtype}{list(a.shape)}, "
                    f"pool block is {want}{list(shape)}"
                )
            arrays.append(a.reshape(-1).view(np.uint8))
        host = np.concatenate(arrays)
        with self._step():
            if self._tp is not None:
                self._tp.dispatch(RESTORE_BLOCK, self._slot, (block, host.size))
            self._fence()  # the copy waits on the stream
            dev = torch.from_numpy(host).to(self.device)
            if self._tp is not None:
                self._tp.broadcast(dev)
            self._restore_local(block, dev)
        self.host_bytes_in += host.size

    def _paged_caches(self, block_tables, context_lens):
        return (self.k_cache, self.v_cache, block_tables, context_lens,
                self.k_scale, self.v_scale)

    # ---------------- prefill ----------------

    def _prefill_program(self, tokens_d, blocks_d):
        """Full prefill on this rank's shard → logits (None off rank 0)."""
        cfg = self.model_config
        logits, kvs = self.model(tokens_d, return_kv=True)
        paged = (blocks_d.shape[0], self.engine_config.block_size,
                 self.local_heads, cfg.head_dim)
        self._scatter(
            [(k[0], v[0]) for k, v in kvs], (blocks_d.long(),), shape=paged
        )
        return logits

    @torch.no_grad()
    def prefill(self, token_ids: Sequence[int], block_ids: Sequence[int]) -> int:
        """Run one prompt through the model, scatter its K/V into the given
        blocks, and return the greedily-sampled next token."""
        ecfg = self.engine_config
        n = len(token_ids)
        bucket = ecfg.bucket_for(n)
        nb = bucket // ecfg.block_size
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :n] = token_ids
        # Bucket padding beyond the sequence's own blocks scatters into the
        # null block; it is garbage that nothing ever reads unmasked.
        blocks = np.zeros((nb,), np.int32)
        blocks[: len(block_ids)] = block_ids
        with self._step():
            logits = self._prefill_program(
                *self._feed(PREFILL, (bucket, nb), (tokens, blocks))
            )
            return int(self._to_host(torch.argmax(logits[0, n - 1, :]))[()])

    @torch.no_grad()
    def prefill_logits(self, token_ids: Sequence[int]) -> np.ndarray:
        """The logits (f32, host) after a full prefill of `token_ids` whose
        K/V all go to the null block: a probe that compares engines'
        numerics at any tp without touching a sequence's blocks."""
        ecfg = self.engine_config
        n = len(token_ids)
        bucket = ecfg.bucket_for(n)
        nb = bucket // ecfg.block_size
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :n] = token_ids
        with self._step():
            logits = self._prefill_program(
                *self._feed(PREFILL, (bucket, nb), (tokens, np.zeros((nb,), np.int32)))
            )
            self._fence()
            out = logits[0, n - 1].float().cpu().numpy()
        self.host_bytes_out += int(out.nbytes)
        return out

    # ---------------- partial prefill (prefix caching) ----------------

    def _suffix_program(self, tokens_d, table_d, lens_d, pos_d, blk_d, off_d):
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
        return logits

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
        arrays = (tokens, table, np.array([offset], np.int32), positions,
                  block_idx, offsets)
        with self._step():
            logits = self._suffix_program(*self._feed(
                PREFILL_SUFFIX, (bucket, ecfg.max_blocks_per_seq), arrays
            ))
            return int(self._to_host(torch.argmax(logits[0, n - 1, :]))[()])

    def _copy_local(self, src: int, dst: int) -> None:
        for pool in (self.k_cache, self.v_cache, self.k_scale, self.v_scale):
            if pool is not None:
                pool[:, dst] = pool[:, src]

    @torch.no_grad()
    def copy_block(self, src: int, dst: int) -> None:
        """Device-copy one block's K/V (and scales) across every layer
        (copy-on-write before a sequence writes into a shared block). Under
        tensor parallelism every rank copies its own heads."""
        with self._step():
            if self._tp is not None:
                self._tp.dispatch(COPY_BLOCK, self._slot, (src, dst))
            self._copy_local(src, dst)
        self.host_bytes_in += 8  # two int32 block ids

    # ---------------- decode / k-token verification ----------------

    def _verify_program(self, tokens_d, tables_d, lens_d, pos_d, blk_d, off_d):
        logits, kvs = self.model(
            tokens_d,
            positions=pos_d,
            paged_caches=self._paged_caches(tables_d, lens_d),
            paged_impl=self.attn_impl,
            return_kv=True,
        )
        self._scatter(kvs, (blk_d.long(), off_d.long()))
        return logits

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
        arrays = (tokens, block_tables, context_lens, positions, block_idx, offsets)
        with self._step():
            logits = self._verify_program(*self._feed(
                VERIFY, (b, s, block_tables.shape[1]), arrays
            ))
            return self._to_host(torch.argmax(logits, dim=-1))

    def _decode_program(
        self, tokens_d, pos_d, tables_d, lens_d, blk_d, off_d
    ) -> Optional[torch.Tensor]:
        """The decode step on device inputs → next_tokens [B] (int64, on
        the device; None off rank 0). `tokens_d` is only read: under async
        scheduling it is the previous step's output."""
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
        return None if logits is None else torch.argmax(logits[:, 0, :], dim=-1)

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
        arrays = (tokens, positions, block_tables, context_lens, block_idx, offsets)
        with self._step():
            next_tokens = self._decode_program(*self._feed(
                DECODE, block_tables.shape, arrays
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
        the same. Under tensor parallelism chained tokens reach the other
        ranks inside the input broadcast, from this device: they never
        cross the host."""
        chained = isinstance(tokens, DeviceTokens)
        block_idx, offsets = self._decode_index(positions, block_tables)
        # Chained token inputs never cross the host boundary — that is
        # part of the win the transfer counters should show.
        host_in = [np.ascontiguousarray(a, np.int32) for a in (
            positions, block_tables, context_lens, block_idx, offsets)]
        if not chained:
            host_in.insert(0, np.ascontiguousarray(tokens, np.int32))
        shapes = [a.shape for a in host_in]
        with self._step():
            slot = None
            if self.device.type == "cuda":
                slot = self._ring_at
                self._ring_at = (slot + 1) % len(self._ring)
                dev = self._stage(host_in, slot)
            else:
                dev = self._upload(host_in)
            if self._tp is None:
                inputs = _views(dev, shapes)
                if chained:
                    inputs = (tokens.tensor,) + inputs
            else:
                if chained:
                    b = tokens.tensor.shape[0]
                    head = torch.zeros(_spans([(b,)])[0], dtype=torch.int32, device=self.device)
                    head[:b] = tokens.tensor
                    dev = torch.cat([head, dev])
                    shapes.insert(0, (b,))
                inputs = self._send(DECODE, block_tables.shape, dev, shapes)
            return self._start_fetch(self._decode_program(*inputs), slot)

    # ---------------- async transfers (CUDA) ----------------

    def _stage(self, arrays, slot: int) -> torch.Tensor:
        """Copy int32 host arrays to the device without a stream
        synchronise: packed into the ring slot's pinned buffer (each
        segment 16-byte aligned, as the kernels require of their inputs)
        and sent by one non-blocking copy; returns the packed device
        buffer. The slot's event, recorded after that copy, is waited on
        before the buffer is refilled — normally long past, since the ring
        is deeper than the engine's in-flight depth of 2."""
        self.host_bytes_in += sum(int(a.nbytes) for a in arrays)
        total = sum(_spans([a.shape for a in arrays]))
        ring = self._ring[slot]
        if ring["in"] is None or ring["in"].numel() < total:
            ring["in"] = torch.empty(total, dtype=torch.int32, pin_memory=True)
        elif ring["in_event"] is not None and not ring["in_event"].query():
            self._fence(ring["in_event"])
        _pack(arrays, ring["in"].numpy())
        dev = ring["in"][:total].to(self.device, non_blocking=True)
        ring["in_event"] = torch.cuda.Event()
        ring["in_event"].record()
        return dev

    def _start_fetch(self, next_tokens: torch.Tensor, slot) -> "DeviceTokens":
        """Queue the sampled tokens' copy into the ring slot's pinned host
        buffer, fenced by an event (slot None: on the CPU, where they are
        on the host already). The slot's previous tokens were fetched at
        their commit, which precedes this dispatch by at least a step."""
        self.host_bytes_out += next_tokens.numel() * 4  # int32 on the host
        if slot is None:
            return DeviceTokens(next_tokens, next_tokens.to(torch.int32).numpy(), None, None)
        ring = self._ring[slot]
        if ring["out"] is None or ring["out"].numel() != next_tokens.numel():
            ring["out"] = torch.empty(
                next_tokens.numel(), dtype=torch.int32, pin_memory=True
            )
        # A new int32 tensor: the chained input itself is never written.
        ring["out"].copy_(next_tokens.to(torch.int32), non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return DeviceTokens(next_tokens, ring["out"], event, self._fence)


def _host_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a pool of `dtype` is stored as on the host:
    bfloat16, which numpy lacks, as its int16 bit pattern."""
    if dtype == torch.bfloat16:
        return np.dtype(np.int16)
    return torch.empty((), dtype=dtype).numpy().dtype


class DeviceTokens:
    """One async decode step's sampled tokens: the device tensor (the next
    chained step's input), the host buffer its copy lands in, the CUDA
    event fencing that copy (None on the CPU, where the values are already
    on the host), and the runner's wait on such an event (`_fence`)."""

    __slots__ = ("tensor", "host", "event", "wait")

    def __init__(self, tensor: torch.Tensor, host, event, wait) -> None:
        self.tensor = tensor
        self.host = host
        self.event = event
        self.wait = wait

    def pending(self) -> bool:
        """Whether the step (and its copy) is still running on the card."""
        return self.event is not None and not self.event.query()

    def fetch(self) -> np.ndarray:
        """The sampled tokens as int32 numpy, waiting on this step's event
        only (not on the whole device)."""
        if self.event is None:
            return self.host
        self.wait(self.event)
        return self.host.numpy().copy()
