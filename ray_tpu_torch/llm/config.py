"""Engine configuration for ray_tpu_torch.llm.

A field-for-field copy of the reference engine's configuration, so the
same EngineConfig describes the same engine in both packages. The fixed
decode batch slots, block-table width and power-of-two prefill buckets
kept XLA's compiled-program count O(1); the port keeps them because they
fix every kernel launch shape (and so the warmup's coverage) in the same
way. Tensor parallelism, which the port does not have yet, still
validates here, and the engine's runner refuses it by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class KVFabricConfig:
    """Fleet-wide KV fabric: a shared host-DRAM spill tier for KV blocks.

    One named store actor (`kv_fabric:{name}`) per fabric holds evicted /
    drained blocks keyed by their content chain hash, bounded by
    `byte_budget` with its own LRU. Engines pointing at the same `name`
    share one logical prefix cache: eviction and drain demote blocks to
    the fabric instead of destroying them, and admission restores fabric
    hits into freshly allocated device slots.
    """

    # Fabric identity: engines with the same name share one store actor.
    name: str = "default"
    # Host-DRAM byte budget for the store's own LRU. Must hold at least
    # one block (checked against the actual per-block byte size at engine
    # construction, where the model dims are known).
    byte_budget: int = 64 * 1024 * 1024
    # Prefix-affinity routing: serve.build_app layers a consistent hash on
    # the prompt's leading block-chain hash onto the router's p2c pick, so
    # multi-turn sessions land where their cache already lives. Routing
    # only — the spill/restore tier works either way.
    affinity: bool = True
    # Bound on every store RPC (single-block put/get/contains/stats; the
    # batch put_many gets 6x — it moves a whole drain flush). A call that
    # exceeds it degrades to a miss/no-op and bumps
    # llm_engine_fabric_timeouts: the fabric is an accelerator, and a
    # HUNG store actor must stall admission/eviction no longer than a
    # dead one would.
    rpc_timeout_s: float = 5.0

    def __post_init__(self):
        if self.rpc_timeout_s <= 0:
            raise ValueError(
                f"kv_fabric.rpc_timeout_s must be > 0, got "
                f"{self.rpc_timeout_s} — an unbounded store RPC lets a "
                "hung store actor stall the engine step loop"
            )
        if not self.name:
            raise ValueError(
                "kv_fabric.name must be non-empty — it names the shared "
                "store actor (kv_fabric:{name}) engines rendezvous on"
            )
        if self.byte_budget < 1:
            raise ValueError(
                f"kv_fabric.byte_budget must be >= 1 byte, got "
                f"{self.byte_budget} — a fabric that can hold nothing "
                "silently degrades every spill to a discard"
            )


# Engine roles for disaggregated prefill/decode. A "prefill" engine runs
# chunked prefill only, publishes each finished block to the fabric, and
# finishes the request at its first token; a "decode" engine admits the
# handed-off request as a pure fabric hit and generates the rest.
ENGINE_ROLES = ("unified", "prefill", "decode")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    # Cache layout. Block 0 is reserved as the null/trash block: block
    # tables pad with it, and masked lanes scatter into it.
    block_size: int = 8
    num_blocks: int = 128
    # Decode runs one jitted program over exactly this many slots; idle
    # slots compute against the null block and are ignored.
    max_decode_slots: int = 8
    # Static width of every block table; bounds sequence length at
    # max_blocks_per_seq * block_size tokens.
    max_blocks_per_seq: int = 16
    # Prefill lengths are padded up to one of these (multiples of
    # block_size); derived as powers of two up to max_model_len if empty.
    prefill_buckets: Tuple[int, ...] = ()
    # How many queued prompts may be prefilled in a single engine step.
    max_prefills_per_step: int = 1
    # Chunked prefill: per-step budget of prompt tokens fed through the
    # prefill programs. Long prompts are split into block-aligned chunks
    # fed through the (already bucketed) partial-prefill programs, one
    # chunk interleaved alongside the decode batch per engine iteration —
    # so a long prompt streams in over several steps instead of
    # monopolizing one, and decode time-per-output-token stays flat.
    # Greedy outputs are token-identical with the budget set or unset.
    #   -1   ("auto", the default): a block-aligned budget of roughly a
    #        quarter of max_model_len (never below one block).
    #   0 / None: chunking off — every prompt prefills in one dispatch,
    #        exactly the pre-chunking behavior.
    #   N > 0: explicit budget; must be a multiple of block_size.
    max_prefill_tokens_per_step: Optional[int] = -1
    # Default generation bound when a request does not specify one.
    default_max_new_tokens: int = 32
    # Automatic prefix caching: full KV blocks are content-addressed
    # (chain-hashed token ids) and freed blocks stay reusable until
    # evicted, so shared system prompts, repeated prompts, and
    # preempt-resume re-prefills skip recomputing the cached prefix.
    # Greedy outputs are token-identical either way.
    enable_prefix_caching: bool = True
    # Which cached-but-unreferenced block to evict under pressure:
    # "lru" (least recently freed/used) or "fifo" (oldest registration).
    prefix_eviction_policy: str = "lru"
    # Poison-request isolation: a step exception attributable to a single
    # request dead-letters only that request (its KV blocks are released
    # and the loop keeps stepping; an isolated failure does not count
    # toward the threshold below). After this many CONSECUTIVE failing
    # steps with no isolatable culprit the engine declares itself wedged:
    # check_health() flips false and the error is broadcast to every
    # waiter so the Serve controller replaces the replica.
    max_consecutive_step_failures: int = 3
    # How many dead-letter records (id, prompt hash, error) to retain.
    dead_letter_capacity: int = 64
    # Paged-attention implementation for the decode / partial-prefill
    # programs: "cuda" runs the hand-written block-table-walking kernel
    # (ops.paged_flash — block gather, QK^T, masking, online softmax and
    # weighted-V in one pass), "reference" the gather+softmax op, and
    # "auto" picks the kernel when the pools live on a CUDA device and
    # the reference on the CPU. Greedy outputs are token-identical across
    # implementations in f32; in bf16 the two take different rounding
    # paths (the kernel pre-scales q in storage dtype, the reference
    # scales f32 logits), so near-tie argmax flips are possible, as with
    # any kernel swap. Warmup runs every bucket with whichever
    # implementation is selected.
    attn_impl: str = "auto"
    # KV-cache pool storage: "auto" follows the model dtype, "bf16"
    # forces bfloat16, and "int8" stores quantized pools with per-token
    # per-head scales (ops.paged_flash.quantize_kv) — roughly half the
    # bytes per cached token, so ~1.9x the sequences fit the same pool
    # and continuous batching keeps more requests in flight. Outputs are
    # within quantization tolerance of bf16; greedy argmax is expected to
    # match on typical prompts but is not bit-guaranteed.
    kv_cache_dtype: str = "auto"
    # Decode-time sampling policy. Only "greedy" (argmax) is implemented;
    # the knob exists so speculative decoding can reject non-greedy
    # configurations explicitly until rejection sampling lands.
    sampling: str = "greedy"
    # Speculative decoding (ray_tpu_torch.llm.spec): "off" decodes one token per
    # sequence per step; "ngram" proposes continuations by matching the
    # sequence's own token history against its tail (prompt lookup — no
    # draft model, pure host-side matching); "draft" runs a second,
    # smaller GPT (draft_model_config) through the same runner harness.
    # Either way the target model scores all k proposed tokens in ONE
    # verify step against the paged KV cache, accepts the longest agreeing
    # prefix plus the correction/bonus token, and rolls back rejected
    # tokens (block-table trim + context-length rewind) — so greedy
    # outputs are token-identical with speculation on or off, and each
    # verify step emits between 1 and k+1 tokens. (Under
    # kv_cache_dtype="int8" the identity inherits int8's own
    # within-quantization-tolerance contract — the caveat partial
    # prefill already carries.)
    speculation: str = "off"
    # How many tokens a proposer may run ahead per verify step (k). The
    # verify program is compiled per fed-width bucket (1 + proposed,
    # powers of two up to k); each sequence speculates at most
    # min(k, its remaining budget - 1, cache capacity).
    num_speculative_tokens: int = 4
    # n-gram proposer: longest/shortest history suffix to match. Longer
    # matches are tried first (higher precision), falling back to shorter.
    ngram_max: int = 3
    ngram_min: int = 1
    # GPTConfig of the draft model (required iff speculation="draft").
    # It must satisfy max_seq_len >= max_model_len, like the target.
    draft_model_config: Optional[Any] = None
    # Intra-replica tensor parallelism: the number of devices one engine
    # spans. 1 (the default) is the single-device path, unchanged. > 1
    # makes the engine's process rank 0 of a group of that many processes,
    # one per device (ray_tpu_torch.parallel.tensor_parallel_group: NCCL on
    # the card, gloo on the CPU), and runs every step program on all of
    # them: GPT weights split Megatron-style (qkv/mlp-in column-parallel,
    # attn-out/mlp-out row-parallel — one all-reduce per block after each
    # row-parallel projection), and the paged KV pools, int8 scale pools,
    # and the draft-model mirror pool all split on the HEAD axis, so each
    # rank's paged-attention kernel reads only its own heads' cache blocks
    # while the allocator/prefix cache/scheduler stay with rank 0 (block
    # ids mean the same on every rank). Requires num_heads of the target
    # AND draft model to be divisible by this, and at least this many
    # visible devices — both checked before any rank starts. Both
    # attn_impl values are supported. Greedy outputs are token-identical
    # to tensor_parallel_size=1 in f32 (the CPU tests and the card's tp
    # phase); in bf16 the partial-sum reduction order differs, so
    # near-tie argmax flips are possible — the same contract as any
    # kernel swap.
    tensor_parallel_size: int = 1
    # Fleet-wide KV fabric (ray_tpu_torch.llm.kvfabric): None (the default)
    # disables every fabric hook and leaves all existing paths bit-for-bit
    # unchanged. A KVFabricConfig turns evictions and drains into demotion
    # (device pool -> host-DRAM store keyed by chain hash) and extends the
    # admission prefix match past the device cache into the fabric.
    kv_fabric: Optional[KVFabricConfig] = None
    # Disaggregated prefill/decode role: "unified" (default) serves both
    # phases; "prefill" runs chunked prefill only, publishing finished
    # blocks to the fabric and completing at the first token; "decode"
    # expects handed-off requests whose prefix blocks are fabric hits.
    # Both non-unified roles require kv_fabric.
    engine_role: str = "unified"
    # Async double-buffered step loop: split each decode step into a
    # dispatch phase and a deferred commit phase, pipelined one step deep.
    # While step N's decode program runs on device, the host plans and
    # dispatches step N+1 with step N's on-device `next_tokens` chained
    # directly into N+1's token input (positions/context_lens advance +1
    # deterministically); an async device->host copy brings N's values
    # back for emission one step behind. Consequences: EOS/max-token
    # finishes are detected one step late (the overshoot token is
    # committed to a scratch position and never emitted), verify/spec
    # steps and batch-composition changes are pipeline-flush boundaries
    # (commit-before-plan), and a poisoned decode commit surfaces one
    # step after its dispatch (failure records attribute against the
    # dispatch index). Greedy outputs are token-identical either way;
    # False (the default) keeps the synchronous loop bit-for-bit.
    async_scheduling: bool = False
    # Bounded admission: cap the scheduler backlog so overload fails fast
    # at submission instead of queueing without bound. None (the default)
    # keeps the waiting deque unbounded — bit-for-bit the pre-overload-
    # control behavior. With a cap set, a submission that would push the
    # backlog past max_queue_len requests (or max_queue_tokens queued
    # prompt tokens, counting running prefills' remaining tokens) is
    # rejected with a typed, retryable EngineOverloadedError carrying a
    # retry-after hint; every rejection lands in the shed ring
    # (LLMEngine.shed_requests()) and bumps llm_engine_shed_requests.
    max_queue_len: Optional[int] = None
    max_queue_tokens: Optional[int] = None
    # How many shed records (id, reason, queue depth) to retain.
    shed_capacity: int = 64
    # Per-request observability: lifecycle phase spans (queue/prefill/
    # decode/preempt via util.tracing), the TTFT / time-per-output-token /
    # queue / e2e / step-seconds histograms, and the per-step flight-
    # recorder ring. False compiles it all out of the step loop (coarse
    # engine gauges/counters and failure records remain).
    instrument: bool = True
    # How many per-step flight-recorder records to retain.
    flight_recorder_capacity: int = 256

    @property
    def max_model_len(self) -> int:
        return self.max_blocks_per_seq * self.block_size

    @property
    def num_usable_blocks(self) -> int:
        return self.num_blocks - 1  # block 0 is the null block

    def buckets(self) -> Tuple[int, ...]:
        if self.prefill_buckets:
            return tuple(sorted(self.prefill_buckets))
        out, b = [], self.block_size
        while b < self.max_model_len:
            out.append(b)
            b *= 2
        out.append(self.max_model_len)
        return tuple(out)

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        if self.num_blocks < 2:
            raise ValueError("num_blocks must be >= 2 (block 0 is reserved)")
        if self.max_decode_slots < 1:
            raise ValueError("max_decode_slots must be >= 1")
        if self.max_consecutive_step_failures < 1:
            raise ValueError("max_consecutive_step_failures must be >= 1")
        if self.dead_letter_capacity < 1:
            raise ValueError("dead_letter_capacity must be >= 1")
        if self.flight_recorder_capacity < 1:
            raise ValueError("flight_recorder_capacity must be >= 1")
        if self.shed_capacity < 1:
            raise ValueError("shed_capacity must be >= 1")
        if self.max_queue_len is not None and self.max_queue_len < 1:
            raise ValueError(
                f"max_queue_len must be >= 1 or None (unbounded), got "
                f"{self.max_queue_len} — a zero cap would shed every request"
            )
        if self.max_queue_tokens is not None and self.max_queue_tokens < 1:
            raise ValueError(
                f"max_queue_tokens must be >= 1 or None (unbounded), got "
                f"{self.max_queue_tokens}"
            )
        budget = self.max_prefill_tokens_per_step
        if budget is not None and budget > 0:
            if budget % self.block_size:
                raise ValueError(
                    f"max_prefill_tokens_per_step {budget} is not a "
                    f"multiple of block_size {self.block_size} — chunks "
                    "must be block-aligned so non-final chunks fill whole "
                    "blocks (prefix-cache publication and CoW depend on it)"
                )
        elif budget is not None and budget not in (0, -1):
            raise ValueError(
                "max_prefill_tokens_per_step must be -1 (auto), 0/None "
                f"(off), or a positive multiple of block_size; got {budget}"
            )
        if self.tensor_parallel_size < 1:
            raise ValueError(
                "tensor_parallel_size must be >= 1, got "
                f"{self.tensor_parallel_size}"
            )
        if self.attn_impl not in ("auto", "cuda", "reference"):
            raise ValueError(
                "attn_impl must be one of ('auto', 'cuda', 'reference'), "
                f"got {self.attn_impl!r}"
            )
        if self.kv_cache_dtype not in ("auto", "bf16", "int8"):
            raise ValueError(
                "kv_cache_dtype must be one of ('auto', 'bf16', 'int8'), "
                f"got {self.kv_cache_dtype!r}"
            )
        if self.speculation not in ("off", "ngram", "draft"):
            raise ValueError(
                "speculation must be one of ('off', 'ngram', 'draft'), "
                f"got {self.speculation!r}"
            )
        if self.sampling != "greedy":
            if self.speculation != "off":
                # Rejection sampling for stochastic decoding is not
                # implemented: verification compares proposals against the
                # target's argmax, which is only correct for greedy.
                raise ValueError(
                    "speculative decoding requires greedy sampling until "
                    "rejection sampling is supported; got "
                    f"sampling={self.sampling!r} with "
                    f"speculation={self.speculation!r}"
                )
            raise ValueError(
                "sampling must be 'greedy' (the only implemented policy), "
                f"got {self.sampling!r}"
            )
        if self.num_speculative_tokens < 1:
            raise ValueError(
                "num_speculative_tokens must be >= 1, got "
                f"{self.num_speculative_tokens}"
            )
        if (
            self.speculation != "off"
            and self.num_speculative_tokens >= self.max_model_len
        ):
            raise ValueError(
                f"num_speculative_tokens {self.num_speculative_tokens} "
                f"must be < max_model_len {self.max_model_len} (a sequence "
                "can never verify more tokens than the cache can hold)"
            )
        if self.ngram_min < 1:
            raise ValueError("ngram_min must be >= 1")
        if self.ngram_max < self.ngram_min:
            raise ValueError(
                f"ngram_max ({self.ngram_max}) must be >= ngram_min "
                f"({self.ngram_min})"
            )
        if self.speculation == "draft" and self.draft_model_config is None:
            raise ValueError(
                'speculation="draft" requires draft_model_config (the '
                "draft GPTConfig)"
            )
        if self.speculation != "draft" and self.draft_model_config is not None:
            raise ValueError(
                "draft_model_config is only meaningful with "
                f'speculation="draft" (got speculation={self.speculation!r});'
                " a silently-ignored draft model is a misconfiguration"
            )
        if self.engine_role not in ENGINE_ROLES:
            raise ValueError(
                f"engine_role must be one of {ENGINE_ROLES}, got "
                f"{self.engine_role!r}"
            )
        if self.engine_role == "prefill":
            if self.kv_fabric is None:
                raise ValueError(
                    'engine_role="prefill" requires kv_fabric: a prefill '
                    "engine's only output is the KV blocks it publishes — "
                    "without a fabric the decode engine can never see them"
                )
            if self.prefill_token_budget is None:
                raise ValueError(
                    'engine_role="prefill" requires chunked prefill '
                    "(max_prefill_tokens_per_step must not be 0/None): "
                    "the prefill role publishes blocks as chunks complete, "
                    "which is the chunked path's block-aligned contract"
                )
        if self.engine_role == "decode" and self.kv_fabric is None:
            raise ValueError(
                'engine_role="decode" requires kv_fabric: a decode engine '
                "admits handed-off requests as fabric hits — without a "
                "fabric every handoff silently degrades to a full re-prefill"
            )
        from ray_tpu_torch.llm.cache import EVICTION_POLICIES

        if self.prefix_eviction_policy not in EVICTION_POLICIES:
            raise ValueError(
                f"prefix_eviction_policy must be one of {EVICTION_POLICIES},"
                f" got {self.prefix_eviction_policy!r}"
            )
        for b in self.prefill_buckets:
            if b % self.block_size:
                raise ValueError(
                    f"prefill bucket {b} is not a multiple of block_size "
                    f"{self.block_size}"
                )
            if b > self.max_model_len:
                raise ValueError(
                    f"prefill bucket {b} exceeds max_model_len "
                    f"{self.max_model_len}"
                )

    @property
    def prefill_token_budget(self) -> Optional[int]:
        """The resolved per-step prefill token budget: None when chunking
        is off (0/None), the explicit value when set, or — for -1 (auto) —
        a block-aligned quarter of max_model_len, never below one block."""
        v = self.max_prefill_tokens_per_step
        if not v:  # 0 or None: chunking off
            return None
        if v == -1:
            quarter = (self.max_model_len // 4) // self.block_size
            return max(1, quarter) * self.block_size
        return v

    def chunk_widths(self) -> Tuple[int, ...]:
        """The prefill buckets the chunked path can dispatch: every chunk
        feeds at most prefill_token_budget tokens, so only buckets up to
        bucket_for(budget) are reachable — warmup compiles exactly this
        set (larger full-prefill programs can never run under a budget).
        The reference analyzer's RTL805 judges the table against the
        bucket table; the port's analyzer does not port that rule (the
        port compiles nothing per shape; ROADMAP §B15). With chunking off
        this is the whole bucket table."""
        budget = self.prefill_token_budget
        if budget is None:
            return self.buckets()
        # A budget at or above the largest bucket can't restrict anything:
        # admission already bounds every prefill to the largest bucket, so
        # the whole table stays reachable.
        cap = self.bucket_for(min(budget, self.buckets()[-1]))
        return tuple(b for b in self.buckets() if b <= cap)

    def bucket_for(self, n: int) -> int:
        for b in self.buckets():
            if b >= n:
                return b
        raise ValueError(
            f"prompt of {n} tokens exceeds max_model_len {self.max_model_len}"
        )

    def verify_buckets(self) -> Tuple[int, ...]:
        """Fed-token widths (1 + proposed tokens, proposal counts bucketed
        to powers of two up to num_speculative_tokens) the k-token verify
        program compiles — O(log k) programs, warmed at init like the
        prefill buckets. Empty when speculation is off."""
        if self.speculation == "off":
            return ()
        out, b = [], 1
        while b < self.num_speculative_tokens:
            out.append(1 + b)
            b *= 2
        out.append(1 + self.num_speculative_tokens)
        return tuple(out)

    def verify_bucket_for(self, n_fed: int) -> int:
        for b in self.verify_buckets():
            if b >= n_fed:
                return b
        raise ValueError(
            f"verify step of {n_fed} fed tokens exceeds the largest verify "
            f"bucket (num_speculative_tokens={self.num_speculative_tokens})"
        )
