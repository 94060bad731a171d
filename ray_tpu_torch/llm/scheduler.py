"""Iteration-level (continuous batching) scheduler.

Every engine step: admit queued prompts into free decode slots while the
cache has room, continue every running sequence by one token, and preempt
under cache pressure. Preemption is recompute-style: the victim's blocks
are freed and it re-enters the front of the waiting queue with its
already-generated tokens folded into the prompt, so a later prefill
restores its state exactly (tokens already streamed out are not re-emitted
— `emitted` survives preemption).

With automatic prefix caching (BlockAllocator docstring) admission is
prefix-aware: the longest chain of cached full blocks matching the head of
`prefill_ids` is shared via refcount bumps, and only the uncached tail is
allocated and recomputed (the engine's partial-prefill program). Because a
preempted victim's full blocks stay cached-but-evictable, recompute
preemption becomes nearly free — the resume prefill is mostly cache hits
unless the pool was under enough pressure to really evict them.

Chunked prefill (EngineConfig.max_prefill_tokens_per_step) splits an
admitted prompt's uncached tail into block-aligned chunks fed over several
engine steps: a sequence is admitted with its whole block table, stays
`prefilling` while num_cached < prefill_len, and only joins the decode
batch once the last chunk commits — so one long prompt never monopolizes
an engine step, and decode latency for every in-flight request stays flat
while the prompt streams in.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ray_tpu_torch.llm.cache import (
    BlockAllocator,
    CacheOutOfBlocks,
    blocks_for_tokens,
    hash_block_tokens,
    prefix_block_hashes,
)


FINISH_EOS = "eos"
FINISH_LENGTH = "length"
FINISH_ABORTED = "aborted"
FINISH_ERROR = "error"  # dead-lettered after poisoning an engine step
FINISH_EXPIRED = "expired"  # end-to-end deadline passed before completion

_arrival = itertools.count()


@dataclasses.dataclass
class Request:
    request_id: str
    prompt_ids: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    # Absolute MONOTONIC deadline (time.monotonic() seconds) after which
    # the request must stop consuming engine resources: still queued →
    # dropped before its prefill ever runs; decoding → aborted with its
    # blocks reclaimed. None (the default) = no deadline, the pre-deadline
    # behavior bit-for-bit. Derived from the client timeout at submission.
    deadline_s: Optional[float] = None


class Sequence:
    """One request's in-flight state."""

    def __init__(self, request: Request):
        self.request = request
        self.generated: List[int] = []
        self.block_table: List[int] = []
        self.num_cached = 0  # tokens whose K/V sit in the paged cache
        self.emitted = 0  # generated tokens already streamed to the caller
        self.arrival = next(_arrival)
        self.finish_reason: Optional[str] = None
        self.num_preemptions = 0
        # Membership flag so a full-slot engine step stays linear (no
        # `seq in running` list scans).
        self.is_running = False
        # Chain keys of this sequence's full, cached blocks, in order.
        self.block_hashes: List[int] = []
        # Copy-on-write owed by the engine before this sequence's prefill:
        # (src, dst) device block copy. Admission holds an extra ref on src
        # until the copy lands.
        self.pending_copy: Optional[Tuple[int, int]] = None
        # Chunked-prefill state machine: admitted → prefilling(offset =
        # num_cached) → decoding. Set at admission to len(prefill_ids) at
        # that moment; the sequence is mid-prefill while num_cached is
        # below it (prefill_ids itself grows as tokens are generated, so
        # the target must be pinned). A preempt-resume re-admission
        # re-pins it, so resumes re-chunk.
        self.prefill_len = 0
        # Chunk dispatches since the current admission (0 = none yet); the
        # engine uses it for first-chunk bookkeeping and chunk-indexed
        # observability records.
        self.num_chunks = 0
        # KV-fabric restore plan: (block, chain_hash) pairs the engine must
        # copy in from the fabric (allocate happened at admission; the
        # engine copies in, then registers — in that order) before this
        # sequence's first prefill chunk. num_cached does NOT cover these
        # until each restore commits, so a failed restore needs no
        # rollback: the slot simply stays a plain prefill target.
        self.pending_restore: List[Tuple[int, int]] = []

    @property
    def prefill_ids(self) -> List[int]:
        # After a preemption the generated suffix is recomputed as prompt.
        return self.request.prompt_ids + self.generated

    @property
    def prefilling(self) -> bool:
        """True while an admitted sequence still has prompt tokens to feed
        (chunked prefill spreads them over several engine steps). A
        prefilling sequence holds its blocks and a decode slot but never
        enters the decode/verify batch — it would read K/V that was never
        computed."""
        return self.is_running and self.num_cached < self.prefill_len

    @property
    def last_token(self) -> int:
        return self.generated[-1] if self.generated else self.request.prompt_ids[-1]

    @property
    def finished(self) -> bool:
        return self.finish_reason is not None


class Scheduler:
    def __init__(
        self,
        allocator: BlockAllocator,
        max_decode_slots: int,
        max_blocks_per_seq: int,
    ):
        self.allocator = allocator
        self.max_decode_slots = max_decode_slots
        self.max_blocks_per_seq = max_blocks_per_seq
        self.waiting: Deque[Sequence] = deque()
        self.running: List[Sequence] = []  # arrival order
        self._active: Dict[str, Sequence] = {}  # request_id -> waiting|running
        self.num_preemptions = 0
        self.num_cow_blocks = 0
        # Observability hook: called with the victim right after it re-enters
        # the waiting queue (engine closes its decode-stretch span and
        # restarts its queue-wait clock). Fires only on preemption, so the
        # steady-state decode path pays nothing for it.
        self.on_preempt = None
        # KV-fabric probe: called with the chain hashes past the device
        # match, returns per-hash membership in the fabric's host tier
        # (KVFabricClient.contains). None (the default) keeps admission
        # exactly the pre-fabric device-only path.
        self.fabric_probe = None

    # ---------------- queue management ----------------

    def add(self, seq: Sequence) -> None:
        rid = seq.request.request_id
        if rid in self._active:
            raise ValueError(f"request_id {rid!r} is already active")
        self._active[rid] = seq
        self.waiting.append(seq)

    def is_active(self, request_id: str) -> bool:
        return request_id in self._active

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def abort(self, request_id: str) -> Optional[Sequence]:
        seq = self._active.pop(request_id, None)
        if seq is None:
            return None
        if seq.is_running:
            self.running.remove(seq)
            seq.is_running = False
            self._release(seq)
        else:
            self.waiting.remove(seq)
        seq.finish_reason = FINISH_ABORTED
        return seq

    # ---------------- deadline expiry ----------------

    def expire_waiting(self, now: float) -> List[Sequence]:
        """Drop every QUEUED sequence whose deadline has passed — before it
        can cost a prefill program. A waiting sequence owns no blocks (a
        preempt-resume victim released its table when preempted), so expiry
        here is pure bookkeeping: pop from the queue, deactivate, mark
        FINISH_EXPIRED. Returns the expired sequences so the engine can
        notify waiters and write expiry records. `now` is monotonic-clock,
        matching Request.deadline_s."""
        expired = [
            s
            for s in self.waiting
            if s.request.deadline_s is not None
            and now >= s.request.deadline_s
        ]
        for seq in expired:
            self.waiting.remove(seq)
            self._active.pop(seq.request.request_id, None)
            seq.finish_reason = FINISH_EXPIRED
        return expired

    def expired_running(self, now: float) -> List[Sequence]:
        """RUNNING sequences whose deadline has passed. Selection only —
        the engine finishes each through its normal teardown path so KV
        blocks, draft-mirror blocks, and any lookahead reservation are all
        reclaimed (and, under async_scheduling, so the deferred-commit
        loop's inactive-sequence skip drops the in-flight orphan token)."""
        return [
            s
            for s in self.running
            if s.request.deadline_s is not None
            and now >= s.request.deadline_s
        ]

    # ---------------- admission (prefill) ----------------

    def schedule_prefills(self, max_prefills: int) -> List[Sequence]:
        """Admit waiting sequences into free slots, FIFO, while the cache
        can hold their full prompt (plus-generated, after preemption)."""
        admitted: List[Sequence] = []
        while (
            self.waiting
            and len(self.running) < self.max_decode_slots
            and len(admitted) < max_prefills
        ):
            seq = self.waiting[0]
            if not self._admit(seq):
                break  # head-of-line blocking is deliberate: FIFO fairness
            self.waiting.popleft()
            seq.is_running = True
            # Pin the chunking target: prefill_ids grows as the sequence
            # generates, so "fully prefilled" must mean the length at
            # admission, not the live property.
            seq.prefill_len = len(seq.prefill_ids)
            seq.num_chunks = 0
            admitted.append(seq)
            self.running.append(seq)
        return admitted

    def schedule_prefill_chunks(
        self, token_budget: Optional[int]
    ) -> List[Tuple[Sequence, int]]:
        """Plan this step's prefill work: walk the running list in arrival
        order and give each still-prefilling sequence the next chunk of its
        prompt, spending at most `token_budget` tokens across the step
        (None = unlimited: each sequence's whole remainder in one chunk,
        the pre-chunking behavior). Non-final chunks are rounded down to a
        block boundary so every chunk but the last fills whole blocks
        (prefix-cache publication and CoW stay block-aligned). The oldest
        prefilling sequence always gets at least one block when any budget
        remains, so chunked requests make monotonic progress; decode slots
        are untouched — decode-ready sequences batch every step regardless
        of how much prefill is in flight."""
        plans: List[Tuple[Sequence, int]] = []
        remaining = token_budget
        for seq in self.running:
            if not seq.prefilling:
                continue
            left = seq.prefill_len - seq.num_cached
            if remaining is None:
                take = left
            else:
                if remaining <= 0:
                    break
                take = min(left, remaining)
                if take < left:
                    # Keep the chunk block-aligned unless it finishes the
                    # prompt. num_cached starts block-aligned (prefix
                    # matches are whole blocks; the CoW case has a 1-token
                    # remainder and never reaches here), so aligned takes
                    # keep it aligned.
                    take = (take // self.allocator.block_size) * (
                        self.allocator.block_size
                    )
                    if take == 0:
                        break
                remaining -= take
            plans.append((seq, take))
        return plans

    def prefill_backlog_tokens(self) -> int:
        """Prompt tokens admitted or queued but not yet fed through a
        prefill program: the chunked-prefill backlog gauge. O(waiting +
        running), called once per engine step (lengths only — building
        prefill_ids would copy every waiting prompt per step)."""
        backlog = sum(
            len(s.request.prompt_ids) + len(s.generated)
            for s in self.waiting
        )
        backlog += sum(
            s.prefill_len - s.num_cached
            for s in self.running
            if s.prefilling
        )
        return backlog

    def _admit(self, seq: Sequence) -> bool:
        """Map `seq`'s block table: share the longest cached block-prefix
        of prefill_ids (refcount bumps) and allocate only the uncached
        tail. Returns False when the pool cannot hold the tail."""
        ids = seq.prefill_ids
        n = len(ids)
        bs = self.allocator.block_size
        total = blocks_for_tokens(n, bs)
        if not self.allocator.enable_prefix_caching:
            if not self.allocator.can_allocate(total):
                return False
            # ray-tpu: lint-ignore[RTL404] the free() below belongs to the
            # prefix-caching branch; this branch allocates (pre-checked
            # above, cannot raise) and returns with the blocks owned
            seq.block_table = self.allocator.allocate(total)
            seq.block_hashes = []
            seq.num_cached = 0
            seq.pending_restore = []
            return True
        hashes = prefix_block_hashes(ids, bs)
        matched = self.allocator.match_prefix(hashes)
        k = len(matched)
        # A fully-cached prompt still needs its last token's logits, and
        # that token's K/V write lands inside the last matched (shared,
        # immutable) block: copy-on-write it.
        cow = k > 0 and k * bs == n
        need = total - k + (1 if cow else 0)
        # KV fabric: extend the prefix match past the device cache into
        # the host tier. Restored blocks land in freshly allocated slots
        # (the leading blocks of `tail` below), capped so at least the
        # final token stays uncached — full fabric coverage would need the
        # CoW machinery against a block that doesn't exist on device yet,
        # and recomputing one trailing block is cheaper than growing a
        # second CoW path.
        f = 0
        if self.fabric_probe is not None and not cow:
            max_restorable = (n - 1) // bs
            if k < max_restorable:
                for hit in self.fabric_probe(hashes[k:max_restorable]):
                    if not hit:
                        break
                    f += 1
        # Shield the matched prefix from being evicted by the tail
        # allocation below (and from anyone else while this seq runs).
        # ray-tpu: lint-ignore[RTL404] nothing between touch and the
        # failure-path free can raise (can_allocate is a pure check and
        # allocate is pre-checked); the engine lock serializes callers
        self.allocator.touch(matched)
        if not self.allocator.can_allocate(need):
            self.allocator.free(matched)
            return False
        tail = self.allocator.allocate(need)
        seq.block_hashes = hashes[:k]
        seq.pending_restore = list(zip(tail[:f], hashes[k : k + f]))
        if cow:
            src, dst = matched[-1], tail[0]
            seq.block_table = matched[:-1] + [dst]
            # The engine device-copies src -> dst before the suffix prefill
            # runs; the extra ref taken on src above is dropped after the
            # copy (engine) or on release (abort in the same step).
            seq.pending_copy = (src, dst)
            seq.num_cached = n - 1
            self.num_cow_blocks += 1
        else:
            seq.block_table = matched + tail
            seq.num_cached = k * bs
        return True

    # ---------------- decode ----------------

    def schedule_decode(self) -> List[Sequence]:
        """Ensure every decode-ready running sequence owns a block for the
        position its next token will be written to; preempt the youngest
        sequences on cache pressure. Returns the decode batch — running
        sequences that are NOT still prefilling (a mid-chunk sequence holds
        its slot and blocks but must not decode from K/V that was never
        computed; admission already allocated its whole table, so it needs
        no block here either)."""
        for seq in list(self.running):
            if not seq.is_running:
                continue  # preempted by an earlier iteration of this loop
            if seq.prefilling:
                continue  # mid-chunk: no decode, no extra block needed
            needed = seq.num_cached // self.allocator.block_size + 1
            if needed > self.max_blocks_per_seq:
                raise RuntimeError(
                    f"sequence {seq.request.request_id} outgrew "
                    f"max_blocks_per_seq={self.max_blocks_per_seq}; the "
                    "engine must bound prompt+max_new_tokens at admission"
                )
            while len(seq.block_table) < needed:
                try:
                    seq.block_table.extend(self.allocator.allocate(1))
                except CacheOutOfBlocks:
                    # Evict the lowest-priority (youngest-arrival) running
                    # sequence — possibly the requester itself. Its keyed
                    # blocks stay cached-but-evictable, so its resume
                    # prefill is mostly hits unless pressure persists.
                    victim = max(self.running, key=lambda s: s.arrival)
                    self.preempt(victim)
                    if victim is seq:
                        break
        return [s for s in self.running if not s.prefilling]

    def reserve_decode_lookahead(self, seqs: List[Sequence]) -> bool:
        """Extend block tables so a CHAINED decode step can run before the
        in-flight step commits: the chained write lands at position
        num_cached + 1 (num_cached has not advanced yet — the in-flight
        token commits it later), needing (num_cached + 1) // bs + 1 blocks
        per sequence. Unlike schedule_decode this NEVER preempts — with a
        step in flight, preemption would reset a sequence whose uncommitted
        token is still on device — and never raises: on pool pressure, a
        per-sequence table cap, or a sequence whose chained write would
        fall past max_blocks_per_seq * bs, it allocates nothing and returns
        False so the engine flushes the pipeline and schedules normally.
        All-or-nothing: the batch chains together or not at all."""
        bs = self.allocator.block_size
        extras: List[Tuple[Sequence, int]] = []
        for seq in seqs:
            needed = (seq.num_cached + 1) // bs + 1
            if needed > self.max_blocks_per_seq:
                return False
            extras.append((seq, max(0, needed - len(seq.block_table))))
        total = sum(extra for _, extra in extras)
        if total and not self.allocator.can_allocate(total):
            return False
        for seq, extra in extras:
            if extra:
                seq.block_table.extend(self.allocator.allocate(extra))
        return True

    def reserve_speculative(self, seq: Sequence, num_tokens: int) -> int:
        """Extend `seq`'s block table so a verify step can write K/V for
        its next token PLUS up to `num_tokens` speculative tokens
        (positions num_cached .. num_cached + num_tokens). Speculation is
        opportunistic: it never preempts another sequence for blocks —
        on pool pressure (or the per-sequence block/length caps) the count
        is shrunk, down to 0 (plain decode). Returns the number of
        speculative tokens actually covered; the caller feeds exactly
        1 + that many tokens. Call after schedule_decode(), which already
        guaranteed the plain-decode block."""
        bs = self.allocator.block_size
        # Length cap: the furthest write lands at position
        # num_cached + num_tokens, which must stay inside the table.
        num_tokens = min(
            num_tokens, self.max_blocks_per_seq * bs - seq.num_cached - 1
        )
        while num_tokens > 0:
            extra = (
                blocks_for_tokens(seq.num_cached + 1 + num_tokens, bs)
                - len(seq.block_table)
            )
            if extra <= 0:
                return num_tokens
            if self.allocator.can_allocate(extra):
                seq.block_table.extend(self.allocator.allocate(extra))
                return num_tokens
            num_tokens -= 1
        return 0

    def rollback(self, seq: Sequence, num_cached: int) -> None:
        """Commit + roll back after a verify step: `num_cached` becomes the
        count of tokens whose K/V is valid in the cache (the accepted
        prefix of what the verify program scattered), and the speculative
        tail blocks past the committed region are freed. Rejected tokens'
        K/V stays in the kept blocks as garbage above num_cached — every
        attention masks positions >= context_len, and the next write
        overwrites it. Trimmed blocks were never published to the prefix
        cache (only full blocks at or below num_cached get chain keys), so
        they return to the plain free list."""
        covered = len(seq.block_table) * self.allocator.block_size
        if num_cached > covered:
            raise ValueError(
                f"rollback target {num_cached} exceeds the {covered} "
                "tokens this sequence's block table covers — the verify "
                "step cannot have written there"
            )
        seq.num_cached = num_cached
        keep = blocks_for_tokens(num_cached, self.allocator.block_size)
        if len(seq.block_table) > keep:
            tail = seq.block_table[keep:]
            del seq.block_table[keep:]
            self.allocator.free(tail)

    def preempt(self, seq: Sequence) -> None:
        """Recompute-style preemption: free the blocks, fold generated
        tokens into the prompt, and put the sequence at the front of the
        waiting queue so it resumes first."""
        self.running.remove(seq)
        seq.is_running = False
        self._release(seq)
        seq.num_preemptions += 1
        self.num_preemptions += 1
        self.waiting.appendleft(seq)
        if self.on_preempt is not None:
            self.on_preempt(seq)

    def finish(self, seq: Sequence, reason: str) -> None:
        self.running.remove(seq)
        seq.is_running = False
        self._release(seq)
        self._active.pop(seq.request.request_id, None)
        seq.finish_reason = reason

    # ---------------- prefix-cache bookkeeping ----------------

    def note_filled_blocks(self, seq: Sequence) -> None:
        """Publish every newly-filled full block of `seq` under its chain
        key so later admissions (including this sequence's own resume after
        a preemption) can share it. Idempotent; call after prefill and
        whenever decode fills a block."""
        if not self.allocator.enable_prefix_caching:
            return
        bs = self.allocator.block_size
        full = seq.num_cached // bs
        if len(seq.block_hashes) >= full:
            return
        stream = seq.request.prompt_ids + seq.generated
        while len(seq.block_hashes) < full:
            j = len(seq.block_hashes)
            prev = seq.block_hashes[-1] if seq.block_hashes else None
            h = hash_block_tokens(prev, stream[j * bs : (j + 1) * bs])
            seq.block_hashes.append(h)
            self.allocator.register(seq.block_table[j], h)

    def _release(self, seq: Sequence) -> None:
        if seq.pending_copy is not None:
            # Admission holds one extra ref on the copy source until the
            # engine performs the device copy; a release before that must
            # drop it too.
            self.allocator.free([seq.pending_copy[0]])
            seq.pending_copy = None
        if seq.block_table:
            self.allocator.free(seq.block_table)
        seq.block_table = []
        seq.block_hashes = []
        seq.num_cached = 0
        seq.pending_restore = []
