"""Draft-model proposer: a second, smaller GPT through the runner harness.

The draft shares everything with the target path except the weights: the
same GPTRunner (prefill / partial-prefill / decode step programs over a
paged cache, on the engine's device and tensor-parallel ranks), its own
block pool (same geometry as
the target's, so the admission math is identical), and recompute-style
state discipline — a released sequence simply re-prefills from its
committed tokens.

Per verify step the proposer (1) catches the draft cache up on the tokens
the target committed since last time (the accepted proposals plus the
correction/bonus token) via the draft's own partial-prefill program, whose
final argmax doubles as the FIRST proposal, then (2) runs k-1 batched
draft decode steps chaining proposals, and (3) rewinds its committed-token
count — proposal K/V stays in the draft blocks as garbage above the
committed length (masked by context_len) until the next catch-up
overwrites it, exactly the target engine's rollback discipline.

The draft cache never feeds the target model: a draft of any quality only
changes how many proposals survive verification, never the output.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ray_tpu_torch.llm.cache import BlockAllocator, blocks_for_tokens
from ray_tpu_torch.llm.spec.proposer import Proposer


class _DraftSeq:
    """Draft-side mirror of one running sequence: its draft block table
    and how many committed tokens the draft cache holds K/V for."""

    __slots__ = ("block_table", "num_cached")

    def __init__(self):
        self.block_table: List[int] = []
        self.num_cached = 0


class DraftModelProposer(Proposer):
    name = "draft"

    def __init__(
        self,
        draft_model_config,
        engine_config,
        params=None,
        seed: int = 0,
        device=None,
        tp_group=None,
    ):
        # Deferred import: model_runner pulls in the model stack, which the
        # host-only ngram path never needs.
        from ray_tpu_torch.llm.model_runner import GPTRunner

        self.engine_config = engine_config
        # Under tensor parallelism the draft shares the target's ranks (the
        # reference's draft shares its mesh): its mirror pool splits on its
        # own head axis, over the same block ids.
        self.runner = GPTRunner(
            draft_model_config, engine_config, params=params, seed=seed,
            device=device, tp_group=tp_group,
        )
        # Prefix caching off: draft state is private per sequence and the
        # engine's own prefix cache already de-duplicates target compute;
        # a second content-addressed map would only complicate release().
        self.allocator = BlockAllocator(
            engine_config.num_blocks,
            engine_config.block_size,
            enable_prefix_caching=False,
        )
        self._state: Dict[str, _DraftSeq] = {}

    # ---------------- Proposer interface ----------------

    def propose(self, seqs, k: int) -> List[List[int]]:
        ecfg = self.engine_config
        props: List[List[int]] = [[] for _ in seqs]
        chain: List[tuple] = []  # (out_index, seq_len, budget, _DraftSeq)
        for i, seq in enumerate(seqs):
            ids = seq.prefill_ids
            n = len(ids)
            # Proposals past the model length or the request's remaining
            # token budget (minus the always-emitted bonus slot) can never
            # be verified — the target trims them, so chaining them would
            # be pure wasted draft dispatches. Chain writes land at
            # positions n .. n + budget - 2.
            budget = min(
                k,
                ecfg.max_model_len - n,
                seq.request.max_new_tokens - len(seq.generated) - 1,
            )
            if budget < 1:
                continue
            budget = self._reserve(seq, n, budget)
            if budget < 1:
                continue
            st = self._state[seq.request.request_id]
            first = self._catch_up(ids, st)
            if first is None:
                continue
            props[i].append(first)
            if budget > 1:
                chain.append((i, n, budget, st))
        # Chain the remaining proposals with BATCHED draft decode steps:
        # every still-active sequence advances one draft token per
        # iteration through the same [max_decode_slots] program shape the
        # target runs.
        slots = ecfg.max_decode_slots
        nb = ecfg.max_blocks_per_seq
        for t in range(1, k):
            live = [
                (i, n, st)
                for (i, n, budget, st) in chain
                if t < budget
                and len(props[i]) == t
                and self._covers(st, n + t)
            ]
            if not live:
                break
            tokens = np.zeros((slots,), np.int32)
            positions = np.zeros((slots,), np.int32)
            tables = np.zeros((slots, nb), np.int32)
            ctx = np.zeros((slots,), np.int32)
            for j, (i, n, st) in enumerate(live):
                tokens[j] = props[i][-1]
                positions[j] = n + t - 1
                tables[j, : len(st.block_table)] = st.block_table
                ctx[j] = n + t - 1
            next_tokens = self.runner.decode(tokens, positions, tables, ctx)
            for j, (i, n, st) in enumerate(live):
                props[i].append(int(next_tokens[j]))
        return props

    def release(self, request_id: str) -> None:
        st = self._state.pop(request_id, None)
        if st is not None and st.block_table:
            self.allocator.free(st.block_table)

    def warmup(self) -> None:
        """Run the draft's programs against the null block (writes to
        block 0 are the masked-lane convention — harmless garbage): every
        prefill bucket, the partial-prefill bucket a catch-up lands in,
        and the batched decode step."""
        ecfg = self.engine_config
        for bucket in ecfg.buckets():
            n = min(bucket, ecfg.max_model_len - 1)
            if n < 1:
                continue
            self.runner.prefill([0] * n, [0] * blocks_for_tokens(n, ecfg.block_size))
            self.runner.prefill_suffix([0] * n, [0], 0)
        slots = ecfg.max_decode_slots
        self.runner.decode(
            np.zeros((slots,), np.int32),
            np.zeros((slots,), np.int32),
            np.zeros((slots, ecfg.max_blocks_per_seq), np.int32),
            np.zeros((slots,), np.int32),
        )

    # ---------------- internals ----------------

    def _covers(self, st: _DraftSeq, tokens: int) -> bool:
        """Whether st's blocks cover a write at position tokens - 1."""
        return len(st.block_table) * self.allocator.block_size >= tokens

    def _reserve(self, seq, n: int, budget: int) -> int:
        """Extend (or create) the draft block table to hold the committed
        `n` tokens plus the proposal chain's writes (positions
        n .. n + budget - 2), shrinking the budget — never evicting
        another sequence's draft state — under pool pressure. Returns the
        affordable budget; 0 releases this sequence's draft state."""
        rid = seq.request.request_id
        bs = self.allocator.block_size
        st = self._state.get(rid)
        if st is None:
            st = _DraftSeq()
            self._state[rid] = st
        while budget >= 1:
            target = blocks_for_tokens(max(n + budget - 1, n), bs)
            extra = target - len(st.block_table)
            if extra <= 0:
                return budget
            if self.allocator.can_allocate(extra):
                # ray-tpu: lint-ignore[RTL404] allocate is pre-checked
                # (cannot raise) and its result lands directly in
                # st.block_table, which release() frees — there is no
                # statement in between for an exception to leak through
                st.block_table.extend(self.allocator.allocate(extra))
                return budget
            budget -= 1
        # Not even the committed tokens fit: drop the mirror; the next
        # propose() retries from scratch under (hopefully) less pressure.
        self.release(rid)
        return 0

    def _catch_up(self, ids: List[int], st: _DraftSeq) -> Optional[int]:
        """Feed the draft the committed tokens it has not seen (the whole
        prompt on first contact or after a release; the accepted tokens
        since, otherwise). The final argmax is the first proposal."""
        n = len(ids)
        if st.num_cached >= n:
            # The engine commits at least one token per step, so the
            # delta is never empty between propose() calls; an equal
            # count means propose() was re-run on unchanged state (step
            # retry) — re-feed the last token to recompute the proposal.
            st.num_cached = n - 1
        delta = ids[st.num_cached :]
        if len(delta) > self.engine_config.buckets()[-1]:
            # Delta outgrew the draft's bucket table (possible only with
            # custom prefill_buckets smaller than max_model_len): skip
            # proposing rather than failing the engine step. Checked up
            # front, so a kernel wrapper's ValueError still propagates.
            return None
        if st.num_cached == 0:
            # The mirror table is sized for the committed tokens PLUS the
            # proposal chain (_reserve), but the prefill program's block
            # vector holds exactly bucket_for(n) // block_size entries:
            # feed only the blocks the tokens occupy.
            nb = blocks_for_tokens(n, self.allocator.block_size)
            first = self.runner.prefill(ids, st.block_table[:nb])
        else:
            first = self.runner.prefill_suffix(
                delta, st.block_table, st.num_cached
            )
        st.num_cached = n
        return int(first)
