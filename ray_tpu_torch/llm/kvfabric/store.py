"""KV fabric store: host-DRAM tier for spilled KV blocks, as an actor.

One named `KVFabricStore` actor per fabric (`kv_fabric:{name}`) holds the
device content of demoted blocks — K/V values plus int8 scales, as numpy
arrays on the host (bfloat16 kept as its int16 bit pattern, see
GPTRunner.extract_block) — keyed by the block's content chain hash (llm.cache
hash_block_tokens). Chain hashes identify whole prefixes, so any engine
on the fabric can restore a hit into its own freshly allocated slot and
trust the content: the fleet shares one logical prefix cache.

The store is bounded by a byte budget with its own LRU: a spill that
would overflow evicts the least-recently-hit entries first, and an entry
larger than the whole budget is refused outright. Pure numpy + stdlib —
the actor never touches torch or a device, so it costs no device memory
and survives any engine's death.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.exceptions import GetTimeoutError


def payload_nbytes(payload: dict) -> int:
    """Total bytes of one block payload's arrays (None entries free)."""
    return sum(
        a.nbytes for a in payload.values() if hasattr(a, "nbytes")
    )


class KVFabricStore:
    """Byte-budgeted LRU of block payloads keyed by chain hash."""

    def __init__(self, byte_budget: int):
        if byte_budget < 1:
            raise ValueError(
                f"fabric byte_budget must be >= 1, got {byte_budget}"
            )
        self._budget = int(byte_budget)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[int, dict]" = OrderedDict()
        self._bytes: Dict[int, int] = {}
        self._bytes_used = 0
        self._hits = 0
        self._misses = 0
        self._puts = 0
        self._evictions = 0

    def put(self, block_hash: int, payload: dict) -> bool:
        """Insert one block payload; True when it is resident afterwards.
        An already-present hash refreshes recency without rewriting (the
        content is immutable — equal chain hashes mean equal prefixes).
        Payloads larger than the whole budget are refused."""
        nbytes = payload_nbytes(payload)
        with self._lock:
            if block_hash in self._entries:
                self._entries.move_to_end(block_hash)
                return True
            if nbytes > self._budget:
                return False
            while self._bytes_used + nbytes > self._budget:
                old_hash, _ = self._entries.popitem(last=False)
                self._bytes_used -= self._bytes.pop(old_hash)
                self._evictions += 1
            self._entries[block_hash] = payload
            self._bytes[block_hash] = nbytes
            self._bytes_used += nbytes
            self._puts += 1
            return True

    def put_many(self, items: List[tuple]) -> int:
        """Batch put of [(block_hash, payload), ...]; returns how many are
        resident afterwards — one RPC for a drain flush."""
        return sum(1 for h, p in items if self.put(h, p))

    def get(self, block_hash: int) -> Optional[dict]:
        with self._lock:
            payload = self._entries.get(block_hash)
            if payload is None:
                self._misses += 1
                return None
            self._entries.move_to_end(block_hash)
            self._hits += 1
            return payload

    def get_many(self, block_hashes: List[int]) -> List[Optional[dict]]:
        """Batch get, one RPC for a whole restore chain. Order-preserving;
        misses are None."""
        return [self.get(h) for h in block_hashes]

    def contains(self, block_hashes: List[int]) -> List[bool]:
        """Batch membership, WITHOUT touching recency or hit counters —
        admission probes contains() first and only a restore that actually
        reads content should count as a hit."""
        with self._lock:
            return [h in self._entries for h in block_hashes]

    def stats(self) -> dict:
        with self._lock:
            return {
                "num_blocks": len(self._entries),
                "bytes_used": self._bytes_used,
                "byte_budget": self._budget,
                "hits": self._hits,
                "misses": self._misses,
                "puts": self._puts,
                "evictions": self._evictions,
            }

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._bytes.clear()
            self._bytes_used = 0

    def ping(self) -> str:
        return "pong"


def get_or_create_fabric_actor(name: str, byte_budget: int):
    """The fabric's shared store actor, named `kv_fabric:{name}` so every
    engine (and every ingress replica's engine) on the same fabric name
    rendezvouses on one store. First creation pins the byte budget."""
    return (
        ray_tpu_torch.remote(KVFabricStore)
        .options(
            name=f"kv_fabric:{name}",
            get_if_exists=True,
            max_concurrency=16,
        )
        .remote(byte_budget)
    )


class KVFabricClient:
    """Engine-side client: thin, synchronous wrapper over the store actor.

    Every method degrades to a miss/no-op when the store actor is gone
    (fleet teardown racing an engine's last steps) — the fabric is an
    accelerator, never a correctness dependency. Every RPC is bounded by
    `rpc_timeout_s` (put_many gets 6x — it moves a whole drain flush in
    one call), so a HUNG store actor stalls the engine no longer than a
    dead one; a timeout degrades to the same miss/no-op but additionally
    fires `on_timeout`, which the engine wires to the
    llm_engine_fabric_timeouts counter — "store is slow" and "store is
    cold" must be distinguishable on a dashboard."""

    def __init__(
        self,
        name: str,
        byte_budget: int,
        rpc_timeout_s: float = 5.0,
        on_timeout: Optional[Callable[[], None]] = None,
    ):
        self.name = name
        self._timeout = float(rpc_timeout_s)
        self._bulk_timeout = 6.0 * self._timeout
        self._on_timeout = on_timeout
        self.num_timeouts = 0
        self._actor = get_or_create_fabric_actor(name, byte_budget)

    def _note_timeout(self) -> None:
        self.num_timeouts += 1
        if self._on_timeout is not None:
            try:
                self._on_timeout()
            except Exception:
                pass  # a counter hook must never break the degrade path

    def put(self, block_hash: int, payload: dict) -> bool:
        try:
            return bool(
                ray_tpu_torch.get(
                    self._actor.put.remote(block_hash, payload),
                    timeout=self._timeout,
                )
            )
        except GetTimeoutError:
            self._note_timeout()
            return False
        except Exception:
            return False

    def put_many(self, items: List[tuple]) -> int:
        if not items:
            return 0
        try:
            return int(
                ray_tpu_torch.get(
                    self._actor.put_many.remote(items),
                    timeout=self._bulk_timeout,
                )
            )
        except GetTimeoutError:
            self._note_timeout()
            return 0
        except Exception:
            return 0

    def get_many(self, block_hashes: List[int]) -> List[Optional[dict]]:
        try:
            return ray_tpu_torch.get(
                self._actor.get_many.remote(list(block_hashes)),
                timeout=self._timeout,
            )
        except GetTimeoutError:
            self._note_timeout()
            return [None] * len(block_hashes)
        except Exception:
            return [None] * len(block_hashes)

    def contains(self, block_hashes: List[int]) -> List[bool]:
        if not block_hashes:
            return []
        try:
            return ray_tpu_torch.get(
                self._actor.contains.remote(list(block_hashes)),
                timeout=self._timeout,
            )
        except GetTimeoutError:
            self._note_timeout()
            return [False] * len(block_hashes)
        except Exception:
            return [False] * len(block_hashes)

    def stats(self) -> dict:
        try:
            return ray_tpu_torch.get(
                self._actor.stats.remote(), timeout=self._timeout
            )
        except GetTimeoutError:
            self._note_timeout()
            return {}
        except Exception:
            return {}
