"""Prefix-affinity routing for LLM requests.

The router's replica pick consults a consistent hash on the prompt's
LEADING block-chain hash (llm.cache.hash_block_tokens over the first
block_size tokens): two requests sharing a first block — multi-turn
sessions over one system prefix, repeated prompts — map to the same
preferred replica, so they land where their KV cache already lives.

Affinity is a TIE-BREAK layered on the router's power-of-two-choices:
excluded/draining replicas are filtered before the preference is
consulted, and a preferred replica without capacity falls back to p2c —
affinity never overrides drain, exclusion, or health.

Rendezvous (highest-random-weight) hashing keeps the mapping consistent:
a replica joining or leaving remaps only the keys that scored highest on
it, not the whole space — exactly the property a drain needs so the
surviving replicas' affinities stay put.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ray_tpu_torch.llm.cache import hash_block_tokens
from ray_tpu_torch.util.consistent_hash import rendezvous_pick

__all__ = ["LLMPrefixAffinity", "leading_block_hash", "rendezvous_pick"]


def leading_block_hash(
    prompt_ids: Sequence[int], block_size: int
) -> Optional[int]:
    """Chain hash of the prompt's first full block — the affinity key.
    None for prompts shorter than one block (no shareable prefix: let
    plain p2c place them)."""
    if len(prompt_ids) < block_size:
        return None
    return hash_block_tokens(None, list(prompt_ids[:block_size]))


class LLMPrefixAffinity:
    """Picklable affinity-key extractor for LLMIngress request dicts —
    declared on the deployment (DeploymentConfig.affinity_key_fn) like
    stream_resume_fn, so every handle built from the app's config routes
    with prefix affinity. Returns the leading block-chain hash, or None
    (no affinity) for malformed/short prompts."""

    def __init__(self, block_size: int):
        self.block_size = int(block_size)

    def __call__(self, args: tuple, kwargs: dict) -> Optional[int]:
        if not args or not isinstance(args[0], dict):
            return None
        prompt_ids = args[0].get("prompt_ids")
        if not prompt_ids:
            return None
        try:
            return leading_block_hash(prompt_ids, self.block_size)
        except Exception:
            return None

    def __eq__(self, other):
        return (
            type(other) is LLMPrefixAffinity
            and other.block_size == self.block_size
        )

    def __repr__(self):
        return f"LLMPrefixAffinity(block_size={self.block_size})"
