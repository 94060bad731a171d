"""Proposer interface + the n-gram / prompt-lookup proposer.

A proposer guesses the next k tokens of each running sequence; the engine
then scores all k guesses in ONE target-model step (GPTRunner.verify) and
keeps the longest agreeing prefix. Proposals therefore only affect SPEED,
never output: a bad guess costs one rejected lane, a good one amortizes a
full decode step across several tokens. Greedy outputs are token-identical
with any proposer (or none).

NgramProposer is pure host-side token matching — no model, no device work
— so it adds nothing to the step loop's host-device pipeline.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Sequence as SeqType

if TYPE_CHECKING:  # pragma: no cover - import cycle guard, typing only
    from ray_tpu_torch.llm.scheduler import Sequence


class Proposer:
    """Pluggable speculative-token source (ray_tpu_torch.llm.spec).

    The engine calls `propose` once per verify step with every decoding
    sequence, and `release` whenever a sequence stops running (finish,
    abort, dead-letter, preemption) so stateful proposers drop any
    per-request resources. Implementations must be deterministic: a
    retried engine step re-runs propose() from unchanged scheduler state
    and must get the same proposals back.
    """

    #: Reported through stats()/flight records.
    name = "base"

    def propose(
        self, seqs: SeqType["Sequence"], k: int
    ) -> List[List[int]]:
        """Up to k proposed continuation tokens per sequence, aligned with
        `seqs`. An empty list means "no guess" — that sequence falls back
        to a plain one-token step inside the verify program."""
        raise NotImplementedError

    def release(self, request_id: str) -> None:
        """Drop per-request proposer state (no-op for stateless ones)."""

    def warmup(self) -> None:
        """Run every launch shape of the device programs the proposer owns
        once (no-op for host-only proposers); called from LLMServer's
        init-time warmup."""


class NgramProposer(Proposer):
    """Prompt-lookup decoding: match the sequence's last n tokens against
    an earlier occurrence in its own history (prompt + generated) and
    propose the tokens that followed that occurrence. No draft model: the
    bet is that generation revisits its own context — quoting the prompt,
    repeating boilerplate, continuing a list — which is exactly where
    decode throughput hurts most. Pure host-side list matching; cost is
    O(history * ngram_max) per sequence per step.
    """

    name = "ngram"

    def __init__(self, ngram_max: int = 3, ngram_min: int = 1):
        if ngram_min < 1 or ngram_max < ngram_min:
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"[{ngram_min}, {ngram_max}]"
            )
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min

    def propose(self, seqs, k: int) -> List[List[int]]:
        return [
            self.match(seq.request.prompt_ids + seq.generated, k)
            for seq in seqs
        ]

    def match(self, tokens: List[int], k: int) -> List[int]:
        """Longest-n-first prompt lookup: the continuation after an
        earlier occurrence of the tail n-gram, truncated to k tokens.
        Among occurrences of the same n-gram, the most recent one with a
        FULL k-token continuation wins (recent context predicts best);
        occurrences near the end of the history — whose continuation is
        cut short by the history itself, as in short-period repetition —
        are kept only as a fallback, longest continuation first."""
        if k < 1:
            return []
        n_tokens = len(tokens)
        for n in range(self.ngram_max, self.ngram_min - 1, -1):
            if n_tokens <= n:
                continue
            tail = tokens[-n:]
            best: List[int] = []
            # Right-to-left: the first full-k match is the most recent.
            for start in range(n_tokens - n - 1, -1, -1):
                if tokens[start : start + n] == tail:
                    # start <= n_tokens - n - 1, so the continuation is
                    # never empty (it may overlap the tail: the match
                    # then predicts the repetition continuing).
                    cont = tokens[start + n : start + n + k]
                    if len(cont) == k:
                        return list(cont)
                    if len(cont) > len(best):
                        best = list(cont)
            if best:
                return best
        return []
