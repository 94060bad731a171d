"""Workload scenarios: seeded generators of realistic request mixes.

A scenario turns a `ScenarioSpec` into a deterministic list of
`LoadRequest`s — same spec (same seed) ⇒ byte-identical prompt set and
request order, which is what makes a loadgen run a reproducible bench
record instead of an anecdote. The generators never consult wall clock,
model outputs, or global RNG state.

The built-in scenarios each exercise a specific part of the serving
stack:

  * ``multiturn`` — sessions whose turn t+1 prompt extends turn t's
    prompt (shared conversation prefixes → prefix-cache hits and, on a
    fully-cached prompt, copy-on-write). All sessions also share one
    system prefix, so blocks are shared ACROSS sessions too.
  * ``longtail`` — lognormal prompt/output lengths: most requests short,
    a heavy tail of long prompts (exercises chunked prefill + bucketing).
  * ``repetitive`` — prompts that repeat a short token pattern
    (exercises the n-gram speculative proposer's prompt lookup).
  * ``poison`` — requests the driver arms a deterministic injected fault
    for; the engine must dead-letter exactly these and the SLO report
    must count them as errors, never as latency samples.
  * ``disconnect`` — streamed requests whose client stops consuming
    after a few tokens (mid-stream disconnect; the serve path must abort
    the engine request so KV/draft blocks free immediately).
  * ``mixed`` — a weighted interleave of the above (the default for the
    BENCH_SERVE sweep).
"""

from __future__ import annotations

import dataclasses
import json
import math
import random
from typing import List, Optional, Tuple

KINDS = ("normal", "poison", "disconnect")


@dataclasses.dataclass(frozen=True)
class LoadRequest:
    """One scheduled request (immutable; the driver builds the serve
    payload from it)."""

    request_id: str
    prompt_ids: Tuple[int, ...]
    max_new_tokens: int
    kind: str = "normal"  # one of KINDS
    scenario: str = ""
    session_id: Optional[str] = None
    turn: Optional[int] = None
    # For kind="disconnect": tokens the client consumes before closing
    # the stream mid-flight.
    disconnect_after: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Declarative scenario description (reusable by future chaos and
    autoscaling work — anything that needs a deterministic traffic shape).

    `max_prompt_len` + `max_new_tokens` must fit the target engine's
    admission rules (prompt + new tokens within max_model_len and the
    largest prefill bucket); `for_engine` derives safe caps."""

    name: str = "mixed"
    num_requests: int = 64
    seed: int = 0
    vocab_size: int = 128
    max_prompt_len: int = 48
    max_new_tokens: int = 8
    # multiturn: shared system prefix + growing per-session history.
    num_sessions: int = 4
    shared_prefix_len: int = 12
    turn_tokens: int = 4
    # longtail: lognormal lengths (median/sigma in token space).
    prompt_len_median: float = 10.0
    prompt_len_sigma: float = 0.8
    output_len_median: float = 5.0
    output_len_sigma: float = 0.5
    # repetitive: short pattern tiled across the prompt.
    pattern_len: int = 4
    # disconnect: tokens consumed before the client walks away.
    min_tokens_before_disconnect: int = 2
    # mixed: (scenario, weight) pairs; weights need not sum to 1.
    mix: Tuple[Tuple[str, float], ...] = (
        ("multiturn", 0.35),
        ("longtail", 0.25),
        ("repetitive", 0.2),
        ("poison", 0.1),
        ("disconnect", 0.1),
    )

    def __post_init__(self):
        if self.vocab_size < 3:
            raise ValueError("vocab_size must be >= 3 (token 0 reserved)")
        if self.max_prompt_len < 4:
            raise ValueError("max_prompt_len must be >= 4")
        # Every generator caps its output budget at max_new_tokens, and
        # the disconnect scenario needs room to consume
        # min_tokens_before_disconnect and still leave the stream
        # mid-flight — validating here is what lets for_engine guarantee
        # every generated request passes engine admission.
        floor = max(2, self.min_tokens_before_disconnect + 2)
        if self.max_new_tokens < floor:
            raise ValueError(
                f"max_new_tokens must be >= {floor} "
                "(min_tokens_before_disconnect + 2, so a disconnect can "
                "land mid-stream)"
            )

    @staticmethod
    def for_engine(
        max_model_len: int,
        largest_bucket: int,
        vocab_size: int,
        **overrides,
    ) -> "ScenarioSpec":
        """A spec whose every request passes the engine's admission
        validation: prompt + max_new_tokens within max_model_len, and the
        whole lifetime within the largest prefill bucket (the
        preempt-resume re-prefill bound)."""
        max_new = int(overrides.pop("max_new_tokens", 8))
        cap = min(max_model_len, largest_bucket + 1)
        max_prompt = cap - max_new
        if max_prompt < 4:
            raise ValueError(
                f"engine too small for the scenario: max_model_len "
                f"{max_model_len} / bucket {largest_bucket} leave "
                f"{max_prompt} prompt tokens after {max_new} new tokens"
            )
        return ScenarioSpec(
            vocab_size=vocab_size,
            max_prompt_len=max_prompt,
            max_new_tokens=max_new,
            **overrides,
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _tokens(rng: random.Random, n: int, vocab: int) -> List[int]:
    # Token 0 is the warmup filler everywhere else; skipping it keeps
    # scenario prompts from colliding with warmup's cached zero blocks.
    return [rng.randrange(1, vocab) for _ in range(n)]


def _lognormal_len(
    rng: random.Random, median: float, sigma: float, lo: int, hi: int
) -> int:
    return max(lo, min(hi, int(rng.lognormvariate(math.log(median), sigma))))


def _multiturn(spec: ScenarioSpec, n: int, rng: random.Random) -> List[LoadRequest]:
    """Turn-major session schedule. Turn t's full prompt is a strict
    prefix of turn t+1's, so a session's next turn re-admits mostly
    cache-hit (and a repeated fully-cached prompt takes the CoW path).
    The "assistant response" folded into the history is a seeded
    placeholder, NOT the model's actual output — the schedule must be
    deterministic before a single token is generated."""
    sys_prefix = _tokens(rng, spec.shared_prefix_len, spec.vocab_size)
    histories: List[List[int]] = [[] for _ in range(spec.num_sessions)]
    turns = [0] * spec.num_sessions
    out: List[LoadRequest] = []
    while len(out) < n:
        progressed = False
        for s in range(spec.num_sessions):
            if len(out) >= n:
                break
            user = _tokens(rng, spec.turn_tokens, spec.vocab_size)
            prompt = sys_prefix + histories[s] + user
            if len(prompt) > spec.max_prompt_len:
                # Session outgrew the context: start a fresh conversation
                # (same session id, history reset — a new chat tab).
                histories[s] = []
                turns[s] = 0
                prompt = sys_prefix + user
                if len(prompt) > spec.max_prompt_len:
                    prompt = prompt[: spec.max_prompt_len]
            out.append(
                LoadRequest(
                    request_id="",  # assigned after the final interleave
                    prompt_ids=tuple(prompt),
                    max_new_tokens=spec.max_new_tokens,
                    scenario="multiturn",
                    session_id=f"sess{s}",
                    turn=turns[s],
                )
            )
            pseudo_response = _tokens(
                rng, spec.max_new_tokens, spec.vocab_size
            )
            histories[s] = prompt[len(sys_prefix):] + pseudo_response
            turns[s] += 1
            progressed = True
        if not progressed:
            break
    return out


def _longtail(spec: ScenarioSpec, n: int, rng: random.Random) -> List[LoadRequest]:
    out = []
    for _ in range(n):
        plen = _lognormal_len(
            rng, spec.prompt_len_median, spec.prompt_len_sigma,
            1, spec.max_prompt_len,
        )
        olen = _lognormal_len(
            rng, spec.output_len_median, spec.output_len_sigma,
            2, spec.max_new_tokens,
        )
        out.append(
            LoadRequest(
                request_id="",
                prompt_ids=tuple(_tokens(rng, plen, spec.vocab_size)),
                max_new_tokens=olen,
                scenario="longtail",
            )
        )
    return out


def _repetitive(spec: ScenarioSpec, n: int, rng: random.Random) -> List[LoadRequest]:
    out = []
    for _ in range(n):
        pattern = _tokens(rng, spec.pattern_len, spec.vocab_size)
        plen = rng.randrange(
            min(spec.pattern_len * 2, spec.max_prompt_len),
            spec.max_prompt_len + 1,
        )
        tiled = (pattern * (plen // spec.pattern_len + 1))[:plen]
        out.append(
            LoadRequest(
                request_id="",
                prompt_ids=tuple(tiled),
                max_new_tokens=spec.max_new_tokens,
                scenario="repetitive",
            )
        )
    return out


def _poison(spec: ScenarioSpec, n: int, rng: random.Random) -> List[LoadRequest]:
    out = []
    for _ in range(n):
        plen = rng.randrange(4, spec.max_prompt_len + 1)
        out.append(
            LoadRequest(
                request_id="",
                prompt_ids=tuple(_tokens(rng, plen, spec.vocab_size)),
                # >= 2 so the armed per-request fault site (first decode of
                # this request) is always reached.
                max_new_tokens=max(2, spec.max_new_tokens // 2),
                kind="poison",
                scenario="poison",
            )
        )
    return out


def _disconnect(spec: ScenarioSpec, n: int, rng: random.Random) -> List[LoadRequest]:
    out = []
    lo = max(1, spec.min_tokens_before_disconnect)
    for _ in range(n):
        plen = rng.randrange(4, spec.max_prompt_len + 1)
        max_new = spec.max_new_tokens  # >= lo + 2 by spec validation
        out.append(
            LoadRequest(
                request_id="",
                prompt_ids=tuple(_tokens(rng, plen, spec.vocab_size)),
                max_new_tokens=max_new,
                kind="disconnect",
                scenario="disconnect",
                disconnect_after=rng.randrange(lo, max_new - 1),
            )
        )
    return out


_GENERATORS = {
    "multiturn": _multiturn,
    "longtail": _longtail,
    "repetitive": _repetitive,
    "poison": _poison,
    "disconnect": _disconnect,
}

SCENARIOS = tuple(_GENERATORS) + ("mixed",)


def _interleave(parts: List[List[LoadRequest]]) -> List[LoadRequest]:
    """Deterministic proportional merge that preserves each part's
    internal order (multiturn turn t must stay ahead of turn t+1).
    Each request sorts by its fractional position within its part;
    sorted() is stable, so ties resolve by part order — no RNG, so the
    interleave can never perturb the byte-identical-schedule contract."""
    keyed = []
    for j, part in enumerate(parts):
        for i, req in enumerate(part):
            keyed.append(((i + 1) / (len(part) + 1), j, i, req))
    keyed.sort(key=lambda t: (t[0], t[1], t[2]))
    return [req for _, _, _, req in keyed]


def generate_requests(spec: ScenarioSpec) -> List[LoadRequest]:
    """Materialize the scenario: `spec.num_requests` LoadRequests with
    deterministic ids ("{name}-s{seed}-{index}"), prompts, and kinds."""
    if spec.name != "mixed" and spec.name not in _GENERATORS:
        raise ValueError(
            f"unknown scenario {spec.name!r}; choose from {SCENARIOS}"
        )
    n = spec.num_requests
    if spec.name == "mixed":
        total_w = sum(w for _, w in spec.mix)
        if total_w <= 0:
            raise ValueError("mixed scenario needs positive weights")
        parts: List[List[LoadRequest]] = []
        remaining = n
        for idx, (name, w) in enumerate(spec.mix):
            if name not in _GENERATORS:
                raise ValueError(f"unknown scenario {name!r} in mix")
            count = (
                remaining
                if idx == len(spec.mix) - 1
                else min(remaining, round(n * w / total_w))
            )
            remaining -= count
            # Per-part RNG derived from (seed, scenario NAME) — names are
            # unique keys in _GENERATORS — so reordering the mix or adding
            # a part cannot reshuffle another part's prompts, and a part
            # inside a mix draws the same stream as the standalone
            # scenario at the same seed.
            rng = random.Random((spec.seed, name).__repr__())
            parts.append(_GENERATORS[name](spec, count, rng))
        requests = _interleave(parts)
    else:
        rng = random.Random((spec.seed, spec.name).__repr__())
        requests = _GENERATORS[spec.name](spec, n, rng)
    return [
        dataclasses.replace(req, request_id=f"{spec.name}-s{spec.seed}-{i:05d}")
        for i, req in enumerate(requests)
    ]


def schedule_fingerprint(requests: List[LoadRequest]) -> str:
    """Canonical JSON of the full request list — two runs are the same
    schedule iff their fingerprints are byte-identical (the determinism
    contract the bench record rests on)."""
    return json.dumps(
        [dataclasses.asdict(r) for r in requests],
        sort_keys=True,
        separators=(",", ":"),
    )
