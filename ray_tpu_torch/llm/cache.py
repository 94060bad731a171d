"""Refcounted, content-addressed paged-KV block allocator.

CPU-side bookkeeping for the preallocated [num_blocks, block_size, H, D]
device pools owned by the model runner. Block 0 is never handed out — it is
the null block that pads block tables and absorbs masked-lane scatters, so
a gather through an id of 0 is always safe (and always masked).

Block ids are storage-format-agnostic: with `kv_cache_dtype="int8"` the
runner keeps int8 pools plus per-token scale tensors addressed by the SAME
block ids, and every device-side block operation (scatter, copy-on-write
`copy_block`) moves values and scales together — so sharing, refcounts,
eviction and CoW here need no notion of quantization. int8 halves the
bytes per cached token, which doubles `num_blocks` for the same HBM: more
sequences resident, fewer preemptions, better continuous batching.

Block ids are also *shard*-invariant: under tensor parallelism
(EngineConfig.tensor_parallel_size > 1) the device pools shard on the HEAD
axis — every chip holds the same [num_blocks, block_size] block grid, just
its own heads' slice of each block — so this allocator, the prefix cache,
and the scheduler stay completely host-global and shard-oblivious. The
bytes that DO change per chip are reported by `kv_pool_bytes_sharded`.

Automatic prefix caching (vLLM-style, restated for this allocator):

  * Every FULL block of a sequence gets a content key: the chain hash of
    its token ids folded with its predecessor's key, so a key identifies
    the whole prefix up to and including that block, not just its own
    tokens. Partial blocks have no key and are never shared.
  * A hash → block map serves cache hits: admission matches the longest
    chain of keys already resident and bumps refcounts instead of
    recomputing the prefix (`match_prefix` + `touch`).
  * `free()` decrements refcounts. A block that reaches refcount 0 with a
    registered key keeps its device content and parks in an *evictable*
    pool; unkeyed blocks return to the plain free list. `allocate()` serves
    the free list first and evicts evictable blocks (LRU by default, FIFO
    as a policy knob) only under pressure — so a preempted or finished
    sequence's prefix stays warm until the space is actually needed.
  * Shared blocks are immutable. The one write that can target a shared
    block — re-prefilling a prompt that is cached in full, where the last
    token's K/V lands inside the last shared block — is copy-on-write: the
    scheduler allocates a private copy and the engine device-copies the
    block before writing (see Scheduler._admit).
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

NULL_BLOCK = 0

EVICTION_LRU = "lru"
EVICTION_FIFO = "fifo"
EVICTION_POLICIES = (EVICTION_LRU, EVICTION_FIFO)


class CacheOutOfBlocks(Exception):
    """Raised when an allocation cannot be satisfied; the scheduler turns
    this into a preemption rather than letting it escape."""


def blocks_for_tokens(num_tokens: int, block_size: int) -> int:
    return -(-num_tokens // block_size)


def kv_pool_bytes_sharded(
    num_layers: int,
    num_blocks: int,
    block_size: int,
    num_heads: int,
    head_dim: int,
    value_itemsize: int,
    scale_itemsize: Optional[int] = None,
    tensor_parallel_size: int = 1,
) -> Dict[str, int]:
    """Byte accounting for BOTH KV pools (K + V values, plus their scale
    tensors when quantized) under head-axis tensor parallelism.

    The pools are [L, N, bs, H, D] (scales [L, N, bs, H]) sharded on H, so
    each chip holds exactly aggregate / tp bytes — the number that decides
    whether a model's cache fits per-chip HBM, which is what
    `tensor_parallel_size` exists to change. Pure-int host math (this
    module is imported by jax-free paths): callers pass itemsizes, e.g.
    `np.dtype(runner.kv_cache_dtype).itemsize`.
    """
    if tensor_parallel_size < 1:
        raise ValueError("tensor_parallel_size must be >= 1")
    if num_heads % tensor_parallel_size:
        raise ValueError(
            f"num_heads {num_heads} not divisible by tensor_parallel_size "
            f"{tensor_parallel_size} (the pools shard on the head axis)"
        )
    slots = num_layers * num_blocks * block_size * num_heads
    per_pool = slots * head_dim * value_itemsize
    if scale_itemsize is not None:
        per_pool += slots * scale_itemsize
    aggregate = 2 * per_pool  # K and V
    return {
        "aggregate": aggregate,
        "per_shard": aggregate // tensor_parallel_size,
        "tensor_parallel_size": tensor_parallel_size,
    }


def hash_block_tokens(
    prev_hash: Optional[int], token_ids: Sequence[int]
) -> int:
    """Chain key for one full block: folds the predecessor block's key, so
    equal keys mean equal *prefixes*, not merely equal block contents."""
    return hash((prev_hash, tuple(token_ids)))


def prefix_block_hashes(
    token_ids: Sequence[int], block_size: int
) -> List[int]:
    """Chain keys for every full block of `token_ids` (a trailing partial
    block has no key — partial blocks are never shared)."""
    out: List[int] = []
    prev: Optional[int] = None
    for start in range(
        0, (len(token_ids) // block_size) * block_size, block_size
    ):
        prev = hash_block_tokens(prev, token_ids[start : start + block_size])
        out.append(prev)
    return out


class BlockAllocator:
    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        enable_prefix_caching: bool = True,
        eviction_policy: str = EVICTION_LRU,
    ):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is reserved)")
        if eviction_policy not in EVICTION_POLICIES:
            raise ValueError(
                f"eviction_policy must be one of {EVICTION_POLICIES}, "
                f"got {eviction_policy!r}"
            )
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_caching = enable_prefix_caching
        self.eviction_policy = eviction_policy
        # LIFO reuse: a just-freed block is the next handed out, so a hot
        # pool touches few distinct cache pages.
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._allocated: set[int] = set()  # ids with refcount >= 1
        self._refs: Dict[int, int] = {}
        # Prefix cache state. _hash_to_block holds the canonical block per
        # chain key (content valid whether the block is referenced or
        # evictable); _evictable maps refcount-0 keyed blocks to their
        # eviction priority (lower evicts first).
        self._hash_to_block: Dict[int, int] = {}
        self._block_hash: Dict[int, int] = {}
        self._evictable: Dict[int, int] = {}
        self._fifo_order: Dict[int, int] = {}
        self._tick = itertools.count()
        self.num_evictions = 0
        # Spill hook: invoked with (block, chain_hash) just before a keyed
        # block's device content is discarded by eviction, while the
        # content is still valid on device — the KV fabric demotes the
        # block to its host-DRAM tier here. The allocator stays jax-free:
        # whoever sets the hook owns the device read. A raising hook is
        # contained so allocator bookkeeping can never be left torn.
        self.on_evict: Optional[Callable[[int, int], None]] = None

    # ---------------- accounting ----------------

    @property
    def num_usable(self) -> int:
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        """Blocks an allocation can claim: unused + evictable."""
        return len(self._free) + len(self._evictable)

    @property
    def num_evictable(self) -> int:
        return len(self._evictable)

    @property
    def num_allocated(self) -> int:
        return len(self._allocated)

    def refcount(self, block: int) -> int:
        return self._refs.get(block, 0)

    def utilization(self) -> float:
        return len(self._allocated) / self.num_usable

    # ---------------- alloc / free ----------------

    def can_allocate(self, n: int) -> bool:
        return n <= self.num_free

    def allocate(self, n: int) -> List[int]:
        if n < 0:
            raise ValueError("cannot allocate a negative block count")
        if n > self.num_free:
            raise CacheOutOfBlocks(
                f"requested {n} blocks, {self.num_free} free "
                f"({len(self._free)} unused + {len(self._evictable)} "
                "evictable)"
            )
        out = []
        for _ in range(n):
            b = self._free.pop() if self._free else self._evict_one()
            self._refs[b] = 1
            self._allocated.add(b)
            out.append(b)
        return out

    def _evict_one(self) -> int:
        b = min(self._evictable, key=self._evictable.__getitem__)
        del self._evictable[b]
        h = self._block_hash.pop(b, None)
        if h is not None and self._hash_to_block.get(h) == b:
            del self._hash_to_block[h]
            if self.on_evict is not None:
                try:
                    self.on_evict(b, h)
                except Exception:
                    pass  # spill is best-effort; eviction must complete
        self._fifo_order.pop(b, None)
        self.num_evictions += 1
        return b

    def evictable_items(self) -> List[Tuple[int, int]]:
        """(block, chain_hash) for every keyed refcount-0 block whose
        device content is still valid — the set a draining engine flushes
        into the KV fabric before its pool dies with the actor."""
        return [
            (b, self._block_hash[b])
            for b in self._evictable
            if b in self._block_hash
        ]

    def free(self, blocks: List[int]) -> None:
        # Validate the whole call before mutating anything: a bad id or a
        # duplicate in one list must not leave the allocator half-updated.
        seen: set[int] = set()
        for b in blocks:
            if b in seen:
                raise ValueError(
                    f"freeing block {b} more than once in a single call"
                )
            seen.add(b)
            if self._refs.get(b, 0) < 1:
                raise ValueError(
                    f"freeing block {b} that is not allocated (double free?)"
                )
        for b in blocks:
            self._refs[b] -= 1
            if self._refs[b]:
                continue
            del self._refs[b]
            self._allocated.discard(b)
            h = self._block_hash.get(b)
            if h is not None and self._hash_to_block.get(h) == b:
                # Content stays valid on device; park it for reuse.
                if self.eviction_policy == EVICTION_FIFO:
                    pri = self._fifo_order.setdefault(b, next(self._tick))
                else:
                    pri = next(self._tick)
                self._evictable[b] = pri
            else:
                self._free.append(b)

    # ---------------- prefix cache ----------------

    def match_prefix(self, block_hashes: Sequence[int]) -> List[int]:
        """Longest chain of cached blocks for these chain keys, in prefix
        order. Returned blocks are NOT protected — `touch` them before any
        allocation can evict them."""
        out: List[int] = []
        for h in block_hashes:
            b = self._hash_to_block.get(h)
            if b is None:
                break
            out.append(b)
        return out

    def touch(self, blocks: Sequence[int]) -> None:
        """Take a reference on cached blocks (reviving evictable ones)."""
        for b in blocks:
            if self._refs.get(b, 0):
                self._refs[b] += 1
            elif b in self._evictable:
                del self._evictable[b]
                self._refs[b] = 1
                self._allocated.add(b)
            else:
                raise ValueError(
                    f"touch of block {b} that is neither allocated nor "
                    "evictable"
                )

    def register(self, block: int, block_hash: int) -> bool:
        """Publish a just-filled full block under its chain key so future
        admissions can share it. First writer wins: if the key is already
        mapped (another sequence computed the same prefix), the caller's
        block stays private and returns to the free list when freed."""
        if not self.enable_prefix_caching:
            return False
        if block == NULL_BLOCK or self._refs.get(block, 0) < 1:
            raise ValueError(
                f"register of block {block} that is not a live allocation"
            )
        if block_hash in self._hash_to_block:
            return False
        self._hash_to_block[block_hash] = block
        self._block_hash[block] = block_hash
        self._fifo_order[block] = next(self._tick)
        return True

    def reset_prefix_cache(self) -> None:
        """Drop every cached-but-unreferenced block and all content keys
        (referenced blocks stay allocated, but lose their keys and will
        return to the plain free list)."""
        self._free.extend(self._evictable)
        self._evictable.clear()
        self._hash_to_block.clear()
        self._block_hash.clear()
        self._fifo_order.clear()
