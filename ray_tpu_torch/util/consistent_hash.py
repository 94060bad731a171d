"""Rendezvous (highest-random-weight) hashing.

The consistent-hash primitive behind prefix-affinity routing: every
caller maps the same key to the same member of a tag set, and a member
joining or leaving remaps only the keys that scored highest on it —
exactly the stability a rolling drain needs so the surviving replicas'
affinities stay put. blake2b rather than the builtin str hash: hash() is
per-process randomized, and the whole point is that N independent
routers agree.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence


def rendezvous_pick(key, tags: Sequence[str]) -> Optional[str]:
    """Highest-random-weight pick of one tag for `key`; None for an
    empty tag set. Deterministic across processes and machines."""
    best_tag, best_score = None, b""
    for tag in tags:
        score = hashlib.blake2b(
            f"{key}:{tag}".encode(), digest_size=8
        ).digest()
        if best_tag is None or score > best_score:
            best_tag, best_score = tag, score
    return best_tag
