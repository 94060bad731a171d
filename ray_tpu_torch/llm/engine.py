"""LLM inference engine: continuous batching over the paged KV cache.

`LLMEngine` is the single-threaded core — one `step()` admits prefills,
feeds each in-flight prompt its next block-aligned chunk under the
per-step token budget (EngineConfig.max_prefill_tokens_per_step — long
prompts stream in over several steps instead of monopolizing one), runs
one iteration-level decode, streams tokens, and retires finished
sequences. `LLMServer` wraps it in-process: a background step loop, a
blocking `generate`, and a `generate_stream` generator.

Observability (util.metrics + util.tracing + llm.observability): tokens/sec
counters, decode batch occupancy, cache utilization, and queue depth, plus
— when EngineConfig.instrument is on — per-request lifecycle spans
(queue/prefill/decode/preempt), TTFT / time-per-output-token / queue / e2e
latency histograms, and a flight-recorder ring of per-step records.

The KV fabric (EngineConfig.kv_fabric, llm.kvfabric) hooks in here: blocks
evicted from the device pool spill to a shared host store, admission
restores a fabric hit into freshly allocated slots, and a prefill-role
engine publishes every block it fills. Tensor parallelism is refused by the
runner, naming its ROADMAP item.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time
import uuid
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch._private.fault_injection import maybe_fail
from ray_tpu_torch.exceptions import EngineOverloadedError, PoisonRequestError
from ray_tpu_torch.llm.cache import BlockAllocator, blocks_for_tokens
from ray_tpu_torch.llm.config import EngineConfig
from ray_tpu_torch.llm.model_runner import GPTRunner
from ray_tpu_torch.llm.observability import (
    HOST_GAP_SECONDS_BOUNDARIES,
    PER_TOKEN_SECONDS_BOUNDARIES,
    REQUEST_SECONDS_BOUNDARIES,
    STEP_SECONDS_BOUNDARIES,
    FlightRecorder,
    RequestTrace,
)
from ray_tpu_torch.llm.scheduler import (
    FINISH_EOS,
    FINISH_ERROR,
    FINISH_EXPIRED,
    FINISH_LENGTH,
    Request,
    Scheduler,
    Sequence,
)
from ray_tpu_torch.llm.spec import build_proposer
from ray_tpu_torch.models.gpt import GPTConfig
from ray_tpu_torch.ops.attention import validate_tp_heads
from ray_tpu_torch.parallel.mesh import TensorParallelError, tensor_parallel_group
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram, get_or_create


class _InflightStep:
    """One dispatched-but-uncommitted decode step (async_scheduling).

    Holds everything the deferred commit needs: the batch exactly as it
    was dispatched (slot order matters — the chained token input is
    slot-aligned), the step's `DeviceTokens` (device tensor + the host
    copy in flight), and the engine step index at dispatch time (failure
    attribution: a commit-time exception is pinned on the step that
    DISPATCHED the program, one step before it surfaces). `commit_idx`
    is the partial-commit resume pointer — after a poison dead-letter
    mid-commit, the retry resumes the loop exactly where it stopped.
    """

    __slots__ = (
        "seqs", "rids", "tokens_dev", "tokens_host",
        "dispatch_step", "commit_idx",
    )

    def __init__(self, seqs, rids, tokens_dev, dispatch_step):
        self.seqs: List[Sequence] = seqs
        self.rids: List[str] = rids
        self.tokens_dev = tokens_dev
        self.tokens_host: Optional[np.ndarray] = None
        self.dispatch_step = dispatch_step
        self.commit_idx = 0


class LLMEngine:
    """Not thread-safe; callers serialize access (LLMServer holds a lock).
    ``device`` defaults to CUDA and raises without it; the draft model of
    ``speculation="draft"`` runs on the same device, its weights from
    ``draft_params`` (a state dict) or seeded like the target's.

    With ``tensor_parallel_size > 1`` the engine's process is rank 0 of a
    group of that many processes, one per device, spawned here once for
    the target and the draft runner alike; `shutdown()` stops the ranks
    and frees their devices."""

    def __init__(
        self,
        model_config: Optional[GPTConfig] = None,
        engine_config: Optional[EngineConfig] = None,
        params=None,
        seed: int = 0,
        device=None,
        draft_params=None,
    ):
        self.model_config = model_config or GPTConfig()
        self.engine_config = engine_config or EngineConfig()
        tp = self.engine_config.tensor_parallel_size
        # Fail fast, before any rank is spawned or any pool built: both
        # models' heads must split evenly over the ranks, and the error
        # names the model at fault.
        validate_tp_heads(self.model_config.num_heads, tp)
        if self.engine_config.draft_model_config is not None:
            validate_tp_heads(
                self.engine_config.draft_model_config.num_heads, tp,
                role="draft model",
            )
        self.runner = self._spec = None
        self._tp_group = (
            tensor_parallel_group(tp, resolve_device(device)) if tp > 1 else None
        )
        try:
            self.runner = GPTRunner(
                self.model_config, self.engine_config, params=params, seed=seed,
                device=device, tp_group=self._tp_group,
            )
            # Speculative decoding (ray_tpu_torch.llm.spec): None when off.
            # The proposer only produces guesses; _run_verify scores them
            # against this engine's own model, so outputs never depend on
            # it. The draft runner lives on the same ranks.
            self._spec = build_proposer(
                self.engine_config, seed=seed, draft_params=draft_params,
                device=self.runner.device, tp_group=self._tp_group,
            )
        except BaseException:
            self.shutdown()
            raise
        self.allocator = BlockAllocator(
            self.engine_config.num_blocks,
            self.engine_config.block_size,
            enable_prefix_caching=self.engine_config.enable_prefix_caching,
            eviction_policy=self.engine_config.prefix_eviction_policy,
        )
        self.scheduler = Scheduler(
            self.allocator,
            self.engine_config.max_decode_slots,
            self.engine_config.max_blocks_per_seq,
        )
        # KV fabric (EngineConfig.kv_fabric): shared host-memory spill tier.
        # None keeps every hook cold — the allocator, scheduler, and step
        # loop behave exactly as without the fabric.
        self._fabric = None
        fcfg = self.engine_config.kv_fabric
        if fcfg is not None:
            block_bytes = self.runner.kv_block_bytes()
            if fcfg.byte_budget < block_bytes:
                raise ValueError(
                    f"kv_fabric.byte_budget ({fcfg.byte_budget} bytes) is "
                    f"smaller than one KV block ({block_bytes} bytes for "
                    "this model/engine config) — a fabric that cannot hold "
                    "a single block can never serve a hit; raise the "
                    "budget or drop the kv_fabric knob"
                )
            # Imported lazily: the kvfabric package's disagg module imports
            # this module, so a top-level import would cycle.
            from ray_tpu_torch.llm.kvfabric.store import KVFabricClient

            self._fabric = KVFabricClient(
                fcfg.name,
                fcfg.byte_budget,
                rpc_timeout_s=fcfg.rpc_timeout_s,
                # A store RPC that exceeds its bound degrades to a miss AND
                # is counted apart (llm_engine_fabric_timeouts): a hung
                # store never stalls admission or eviction, and "store is
                # slow" stays distinguishable from "store is cold". The
                # callback only fires on later RPCs, after __init__.
                on_timeout=self._note_fabric_timeout,
            )
            # Spill on device eviction: demote a keyed block's content to
            # the host tier just before the allocator discards it.
            self.allocator.on_evict = self._spill_block
            # Admission extends the prefix match past the device cache.
            self.scheduler.fabric_probe = self._fabric.contains
        # A prefill-role engine's whole output is the KV blocks it
        # publishes: push every newly filled block eagerly, so the reply
        # to the caller is the barrier the decode-role admission needs.
        self._publish_on_fill = (
            self._fabric is not None
            and self.engine_config.engine_role == "prefill"
        )
        self._on_token: Dict[str, Callable[[int], None]] = {}
        self._on_finish: Dict[str, Callable[[Sequence], None]] = {}

        # Engines share one registered metric per name (several engines can
        # coexist in-process); each engine is its own series via the
        # `engine` tag.
        self._metric_tags = {"engine": uuid.uuid4().hex[:8]}
        self._tokens_generated = get_or_create(
            Counter,
            "llm_engine_generated_tokens",
            "Tokens generated (prefill+decode)",
            tag_keys=("engine",),
        )
        self._preemptions = get_or_create(
            Counter,
            "llm_engine_preemptions",
            "Sequences preempted on cache pressure",
            tag_keys=("engine",),
        )
        self._occupancy = get_or_create(
            Gauge,
            "llm_engine_batch_occupancy",
            "Active decode slots / max_decode_slots, last step",
            tag_keys=("engine",),
        )
        self._cache_util = get_or_create(
            Gauge,
            "llm_engine_cache_utilization",
            "Allocated KV blocks / usable",
            tag_keys=("engine",),
        )
        self._queue_depth = get_or_create(
            Gauge,
            "llm_engine_queue_depth",
            "Requests waiting for a decode slot",
            tag_keys=("engine",),
        )
        self._prefix_hits = get_or_create(
            Counter,
            "llm_engine_prefix_cache_hit_tokens",
            "Prompt tokens served from the prefix cache instead of computed",
            tag_keys=("engine",),
        )
        self._prefix_hit_rate = get_or_create(
            Gauge,
            "llm_engine_prefix_cache_hit_rate",
            "Cumulative prefix-cache hit tokens / prefill tokens",
            tag_keys=("engine",),
        )
        self._evictable_blocks = get_or_create(
            Gauge,
            "llm_engine_evictable_blocks",
            "Cached-but-unreferenced KV blocks (reusable until evicted)",
            tag_keys=("engine",),
        )
        self._dead_letter_count = get_or_create(
            Counter,
            "llm_engine_dead_letter_requests",
            "Requests failed in isolation after poisoning an engine step",
            tag_keys=("engine",),
        )
        self._shed_count = get_or_create(
            Counter,
            "llm_engine_shed_requests",
            "Submissions rejected fast by bounded admission "
            "(max_queue_len / max_queue_tokens) or dead-on-arrival "
            "deadlines — typed overload sheds, not failures",
            tag_keys=("engine",),
        )
        self._expired_count = get_or_create(
            Counter,
            "llm_engine_expired_requests",
            "Admitted requests dropped at their end-to-end deadline "
            "(queued: before any prefill ran; decoding: aborted "
            "mid-stream with blocks reclaimed)",
            tag_keys=("engine",),
        )
        self._prefill_backlog = get_or_create(
            Gauge,
            "llm_engine_prefill_backlog_tokens",
            "Prompt tokens admitted or queued but not yet fed through a "
            "prefill program (chunked prefill drains this at "
            "max_prefill_tokens_per_step per engine step)",
            tag_keys=("engine",),
        )
        self._spec_proposed = get_or_create(
            Counter,
            "llm_engine_spec_proposed_tokens",
            "Speculative tokens scored by the verify program",
            tag_keys=("engine",),
        )
        self._spec_accepted = get_or_create(
            Counter,
            "llm_engine_spec_accepted_tokens",
            "Speculative tokens that matched the target argmax and were "
            "committed (excludes the always-emitted correction/bonus token)",
            tag_keys=("engine",),
        )
        self._spec_acceptance = get_or_create(
            Gauge,
            "llm_engine_spec_acceptance_rate",
            "Cumulative accepted / proposed speculative tokens",
            tag_keys=("engine",),
        )
        self._fabric_spills = get_or_create(
            Counter,
            "llm_engine_fabric_spill_blocks",
            "KV blocks demoted to the fabric host tier (eviction spill, "
            "prefill-role publication, drain flush)",
            tag_keys=("engine",),
        )
        self._fabric_restores = get_or_create(
            Counter,
            "llm_engine_fabric_restore_blocks",
            "KV blocks restored from the fabric into device slots",
            tag_keys=("engine",),
        )
        self._fabric_hits = get_or_create(
            Counter,
            "llm_engine_fabric_hit_blocks",
            "Admission-probe hits: blocks found in the fabric past the "
            "device prefix match",
            tag_keys=("engine",),
        )
        self._fabric_hit_rate = get_or_create(
            Gauge,
            "llm_engine_fabric_hit_rate",
            "Cumulative fabric-restored tokens / prefill tokens (the "
            "fabric's own share of the prefix-cache hit rate)",
            tag_keys=("engine",),
        )
        self._fabric_bytes_used = get_or_create(
            Gauge,
            "llm_engine_fabric_bytes_used",
            "Fabric store occupancy in bytes (the store is shared across "
            "engines on the fabric; refreshed on stats scrape)",
            tag_keys=("engine",),
        )
        self._fabric_timeouts = get_or_create(
            Counter,
            "llm_engine_fabric_timeouts",
            "Fabric store RPCs that exceeded kv_fabric.rpc_timeout_s and "
            "degraded to a miss/no-op (a hung store never stalls "
            "admission or eviction)",
            tag_keys=("engine",),
        )
        # Request-level latency histograms (the serving SLO trio + queue):
        # observed only at lifecycle boundaries, never per token.
        self._h_ttft = get_or_create(
            Histogram,
            "llm_request_ttft_seconds",
            "Submission to first generated token",
            boundaries=REQUEST_SECONDS_BOUNDARIES,
            tag_keys=("engine",),
        )
        self._h_tpot = get_or_create(
            Histogram,
            "llm_request_time_per_output_token_seconds",
            "Mean inter-token latency after the first token, per completed request",
            boundaries=PER_TOKEN_SECONDS_BOUNDARIES,
            tag_keys=("engine",),
        )
        self._h_queue = get_or_create(
            Histogram,
            "llm_request_queue_time_seconds",
            "Waiting-for-a-decode-slot time (one sample per admission, "
            "including preempt-resume re-admissions)",
            boundaries=REQUEST_SECONDS_BOUNDARIES,
            tag_keys=("engine",),
        )
        self._h_e2e = get_or_create(
            Histogram,
            "llm_request_e2e_seconds",
            "Submission to terminal state",
            boundaries=REQUEST_SECONDS_BOUNDARIES,
            tag_keys=("engine",),
        )
        self._h_step = get_or_create(
            Histogram,
            "llm_engine_step_seconds",
            "One engine phase dispatch (prefill per chunk per sequence, "
            "decode or speculative verify per batched step); chunk=cont "
            "marks a mid-prompt prefill chunk, chunk=final the dispatch "
            "that completes a prompt (n/a for decode/verify)",
            boundaries=STEP_SECONDS_BOUNDARIES,
            tag_keys=("engine", "phase", "attn_impl", "chunk"),
        )
        self._h_host_gap = get_or_create(
            Histogram,
            "llm_engine_step_host_gap_seconds",
            "Host time between consecutive decode/verify device "
            "dispatches: how long the previous step's results had been "
            "sitting on host before the next program was queued — the "
            "device's scheduling-induced idle window, and the number "
            "async_scheduling exists to shrink. A chained async dispatch "
            "issued BEFORE the previous step's results were fetched "
            "records 0.",
            boundaries=HOST_GAP_SECONDS_BOUNDARIES,
            tag_keys=("engine",),
        )
        # Which paged-attention implementation the runner resolved (CUDA
        # kernel vs reference): tagged onto the step histograms and the
        # per-step flight records so a speedup (or regression) can be
        # attributed to the kernel.
        self._attn_impl = self.runner.attn_impl
        self._tp = self.runner.tensor_parallel_size
        # Pre-merged tag dicts so the step loop never builds dicts. Full
        # prefill runs the dense flash kernel, not the paged one, so its
        # series is tagged "n/a"; only the partial-prefill and decode
        # programs dispatch on attn_impl.
        self._step_tags = {
            phase: {
                **self._metric_tags,
                "phase": phase,
                "attn_impl": (
                    "n/a" if phase == "prefill" else self._attn_impl
                ),
                "chunk": (
                    "n/a" if phase in ("decode", "verify") else "final"
                ),
            }
            for phase in ("prefill", "partial_prefill", "decode", "verify")
        }
        self._chunk_step_tags = {
            phase: {**self._step_tags[phase], "chunk": "cont"}
            for phase in ("prefill", "partial_prefill")
        }
        # Resolved once: None = chunking off (whole prompts in one
        # dispatch), else the per-step prompt-token budget.
        self._prefill_budget = self.engine_config.prefill_token_budget
        # Observability plane (EngineConfig.instrument): per-request phase
        # spans + the per-step flight-recorder ring. The recorder object
        # always exists (step FAILURES are recorded regardless), but
        # per-step records and spans are skipped when instrument=False.
        self._instrument = self.engine_config.instrument
        self.flight_recorder = FlightRecorder(
            self.engine_config.flight_recorder_capacity
        )
        self._req_traces: Dict[str, RequestTrace] = {}
        if self._instrument or self._spec is not None:
            # Preemption must also drop a stateful proposer's per-request
            # resources (draft KV blocks) — the resume re-prefills both
            # caches — so the hook installs whenever either plane needs it.
            self.scheduler.on_preempt = self._note_preempt
        # Poison-request isolation: records of requests failed in isolation
        # after an attributable step exception, newest last.
        self._dead_letters: deque = deque(
            maxlen=self.engine_config.dead_letter_capacity
        )
        # Overload control plane. The shed ring mirrors the dead-letter
        # ring for bounded-admission rejections (shed_requests());
        # _deadline_count gates the per-step expiry sweep.
        self._sheds: deque = deque(maxlen=self.engine_config.shed_capacity)
        self._shed_total = 0
        self._expired_total = 0
        self._fabric_timeout_total = 0
        self._deadline_count = 0
        # Request whose per-sequence section of step() is currently running;
        # a step exception raised there is attributed to it.
        self._current_rid: Optional[str] = None
        self._steps = 0
        self._decode_tokens = 0
        self._decode_slot_steps = 0
        self._prefill_tokens = 0
        self._prefill_chunk_dispatches = 0  # prefill program dispatches
        self._chunked_prefill_requests = 0  # prompts that took > 1 chunk
        self._cache_hit_tokens = 0
        self._fabric_spilled_total = 0
        self._fabric_restored_total = 0
        self._fabric_hit_total = 0
        self._fabric_restored_tokens = 0
        self._spec_proposed_total = 0
        self._spec_accepted_total = 0
        self._spec_emitted_total = 0
        self._verify_steps = 0
        # Async (double-buffered) step loop state. `_inflight` holds
        # dispatched-but-uncommitted decode records, oldest first; depth
        # is transiently 2 between a chained dispatch and the commit of
        # the record it chained from. Always empty with async off.
        self._async = self.engine_config.async_scheduling
        self._inflight: Deque[_InflightStep] = deque()
        # Dispatch index of the record being committed right now: a
        # commit-time failure is attributed one step late, against the
        # step that dispatched the failing program (failure_step()).
        self._attribution_step: Optional[int] = None
        # Host-gap apparatus (both loop modes): perf_counter stamp of the
        # moment the previous decode/verify results became host-readable,
        # the per-step gap/dispatch/commit fields the flight record
        # carries, and the cumulative aggregates stats() exposes.
        self._last_ready_t: Optional[float] = None
        self._step_gap: Optional[float] = None
        self._step_dispatch_wall: Optional[float] = None
        self._step_commits: List[dict] = []
        self._step_ready_wall: Optional[float] = None
        self._step_prefill_s = 0.0
        # Seconds this step spent blocked on fabric store RPCs and block
        # copy-ins: the fleet ledger's fabric-wait column
        # (observability.ledger).
        self._step_fabric_wait_s = 0.0
        self._host_gap_total = 0.0
        self._host_gap_count = 0
        self._host_gap_last: Optional[float] = None
        # Preallocated per-step decode/verify input buffers, zero-filled
        # and repopulated each dispatch (the steady decode loop does no
        # numpy allocation for its inputs). Reuse is safe: the sync runner
        # returns only after the step's tokens are on the host, and
        # decode_async copies them into its own staging buffers at dispatch.
        slots = self.engine_config.max_decode_slots
        nb = self.engine_config.max_blocks_per_seq
        self._dec_tokens = np.zeros((slots,), np.int32)
        self._dec_positions = np.zeros((slots,), np.int32)
        self._dec_block_tables = np.zeros((slots, nb), np.int32)
        self._dec_context_lens = np.zeros((slots,), np.int32)
        self._verify_inputs = (
            {
                s: (
                    np.zeros((slots, s), np.int32),
                    np.zeros((slots, nb), np.int32),
                    np.zeros((slots,), np.int32),
                    np.zeros((slots,), np.int32),
                )
                for s in self.engine_config.verify_buckets()
            }
            if self._spec is not None
            else {}
        )
        self._start = time.monotonic()

    # ---------------- request lifecycle ----------------

    def admission_refusal(
        self, prompt_len: int, max_new_tokens: int
    ) -> Optional[str]:
        """Why a request of this shape can never be admitted under this
        config, or None when it can."""
        ecfg = self.engine_config
        if prompt_len < 1:
            return "prompt_ids must be non-empty"
        if max_new_tokens < 1:
            return "max_new_tokens must be >= 1"
        total = prompt_len + max_new_tokens
        if total > ecfg.max_model_len:
            return (
                f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) "
                f"= {total} exceeds max_model_len {ecfg.max_model_len}"
            )
        # A preempted sequence re-prefills prompt+generated (up to total-1
        # tokens), so the whole lifetime must fit the bucket table and the
        # block pool — otherwise the request could never be (re)admitted and
        # the engine would spin without progress.
        largest_bucket = ecfg.buckets()[-1]
        if total - 1 > largest_bucket:
            return (
                f"prompt + max_new_tokens - 1 = {total - 1} exceeds the "
                f"largest prefill bucket {largest_bucket}; raise "
                "prefill_buckets or shorten the request"
            )
        need_blocks = blocks_for_tokens(total, ecfg.block_size)
        if need_blocks > self.allocator.num_usable:
            return (
                f"request needs {need_blocks} cache blocks but the pool "
                f"only has {self.allocator.num_usable}; raise num_blocks"
            )
        return None

    def add_request(
        self,
        prompt_ids: List[int],
        max_new_tokens: Optional[int] = None,
        eos_id: Optional[int] = None,
        request_id: Optional[str] = None,
        on_token: Optional[Callable[[int], None]] = None,
        on_finish: Optional[Callable[[Sequence], None]] = None,
        deadline_s: Optional[float] = None,
    ) -> str:
        ecfg = self.engine_config
        if max_new_tokens is None:
            max_new_tokens = ecfg.default_max_new_tokens
        if ecfg.engine_role == "prefill":
            # A prefill-role engine never decodes: the request finishes at
            # its first sampled token, after every full prompt block has
            # been published to the fabric for the decode-role engine.
            max_new_tokens = 1
        prompt_ids = [int(t) for t in prompt_ids]
        refusal = self.admission_refusal(len(prompt_ids), max_new_tokens)
        if refusal is not None:
            raise ValueError(refusal)
        request_id = request_id or uuid.uuid4().hex
        if self.scheduler.is_active(request_id):
            raise ValueError(f"request_id {request_id!r} is already active")
        if deadline_s is not None:
            # Dead-on-arrival: the deadline (monotonic, set at the client
            # boundary) passed in transit. Admitting it would spend a
            # prefill program on tokens no caller can use.
            now = time.monotonic()
            if now >= deadline_s:
                self._record_shed(request_id, "expired_at_submit", 0.0)
                raise TimeoutError(
                    f"request {request_id} arrived "
                    f"{now - deadline_s:.3f}s past its deadline"
                )
        cap_len = ecfg.max_queue_len
        cap_tok = ecfg.max_queue_tokens
        if cap_len is not None or cap_tok is not None:
            qlen = len(self.scheduler.waiting)
            reason = None
            if cap_len is not None and qlen >= cap_len:
                reason = f"queue_len {qlen} >= max_queue_len {cap_len}"
            elif cap_tok is not None:
                qtok = self.scheduler.prefill_backlog_tokens()
                if qtok + len(prompt_ids) > cap_tok:
                    reason = (
                        f"queued tokens {qtok} + prompt {len(prompt_ids)} "
                        f"> max_queue_tokens {cap_tok}"
                    )
            if reason is not None:
                # Rough drain hint, never a guarantee: one admission wave
                # per queued request ahead of the caller, capped.
                retry_after = min(
                    2.0, 0.05 * (1.0 + qlen / ecfg.max_decode_slots)
                )
                self._record_shed(request_id, reason, retry_after)
                raise EngineOverloadedError(
                    engine=self._metric_tags["engine"],
                    reason=reason,
                    queue_len=qlen,
                    retry_after_s=retry_after,
                )
        req = Request(
            request_id=request_id,
            prompt_ids=prompt_ids,
            max_new_tokens=max_new_tokens,
            eos_id=eos_id,
            deadline_s=deadline_s,
        )
        if on_token is not None:
            self._on_token[request_id] = on_token
        if on_finish is not None:
            self._on_finish[request_id] = on_finish
        self.scheduler.add(Sequence(req))
        if deadline_s is not None:
            self._deadline_count += 1
        if self._instrument:
            # Submission runs on the caller's thread, so the ambient trace
            # context chains this request's lifecycle spans under the
            # caller's span. The engine loop thread later emits against
            # the captured context explicitly.
            self._req_traces[request_id] = RequestTrace(
                request_id, tracing.capture_context()
            )
        return request_id

    def abort(self, request_id: str) -> bool:
        seq = self.scheduler.abort(request_id)
        if seq is not None:
            self._finished(seq)
            return True
        return False

    def has_work(self) -> bool:
        # An in-flight async record is work even when the scheduler is
        # empty (every member aborted mid-flight): one more step drains
        # it, so callers' step loops never strand a dispatched program.
        return self.scheduler.has_work() or bool(self._inflight)

    def shutdown(self) -> None:
        """Free the other ranks' shards of this engine's runners and stop
        the ranks (their devices are freed as they exit). Idempotent;
        nothing to do at tensor_parallel_size 1."""
        for runner in (self.runner, getattr(self._spec, "runner", None)):
            if runner is not None:
                runner.close()
        if self._tp_group is not None:
            self._tp_group.close()

    # ---------------- poison-request isolation ----------------

    def culprit_for(self, exc: BaseException) -> Optional[str]:
        """Which active request a step exception is attributable to: the
        exception's own request_id (PoisonRequestError and injected faults
        carry one) or the request whose per-sequence section of step() was
        running. None when the failure can't be pinned on one request."""
        if isinstance(exc, TensorParallelError):
            return None  # the engine's ranks, not one request
        rid = getattr(exc, "request_id", None) or self._current_rid
        if rid and self.scheduler.is_active(rid):
            return rid
        return None

    def failure_step(self) -> int:
        """Step index a failure surfacing NOW should be attributed to.
        Under async_scheduling a decode program's commit runs one step
        after its dispatch, so an exception raised inside the commit loop
        belongs to the in-flight record's DISPATCH index (where the
        failing program and its batch actually ran) — not the current
        step counter. Outside a commit this is simply the current step."""
        if self._attribution_step is not None:
            return self._attribution_step
        return self._steps

    def fail_request(self, request_id: str, exc: BaseException) -> bool:
        """Fail one request in isolation: release its KV blocks, record a
        dead letter, and fire its finish callback (finish_reason="error").
        Returns False when the request is not active."""
        seq = self.scheduler.abort(request_id)
        if seq is None:
            return False
        seq.finish_reason = FINISH_ERROR
        prompt = seq.request.prompt_ids
        self._dead_letters.append(
            {
                "request_id": request_id,
                "prompt_hash": hashlib.sha1(
                    ",".join(map(str, prompt)).encode()
                ).hexdigest()[:16],
                "prompt_len": len(prompt),
                "tokens_generated": len(seq.generated),
                "error": repr(exc),
                "step": self.failure_step(),
                "time": time.time(),
            }
        )
        self._dead_letter_count.inc(tags=self._metric_tags)
        rt = self._req_traces.get(request_id)
        if rt is not None:
            rt.error = repr(exc)
        self._finished(seq)
        return True

    def dead_letters(self) -> List[dict]:
        """Records of requests failed in isolation, oldest first (bounded
        by EngineConfig.dead_letter_capacity)."""
        return list(self._dead_letters)

    # ---------------- overload control ----------------

    def _record_shed(
        self, request_id: Optional[str], reason: str, retry_after_s: float
    ) -> None:
        """One rejected submission: ring entry (shed_requests()), counter,
        and a flight-recorder shed record."""
        qlen = len(self.scheduler.waiting)
        self._sheds.append(
            {
                "request_id": request_id,
                "reason": reason,
                "queue_len": qlen,
                "retry_after_s": retry_after_s,
                "step": self._steps,
                "time": time.time(),
            }
        )
        self._shed_total += 1
        self._shed_count.inc(tags=self._metric_tags)
        self.flight_recorder.record_shed(
            request_id, reason, qlen, self._steps
        )

    def shed_requests(self) -> List[dict]:
        """Records of submissions rejected by bounded admission (or dead
        on arrival), oldest first (bounded by EngineConfig.shed_capacity)."""
        return list(self._sheds)

    def _expire_deadlines(self) -> None:
        """Per-step deadline enforcement (monotonic clock, matching
        Request.deadline_s). Runs at the top of step(), so a queued request
        whose deadline passed is dropped BEFORE schedule_prefills can feed
        it to a prefill program, and a decoding one goes through the normal
        finish teardown — KV blocks, draft-mirror blocks, and any
        lookahead reservation reclaimed within this step. Under
        async_scheduling the sweep precedes the chain attempt: an expiry
        is a batch-composition change, so the pipeline flushes and
        _commit_head's inactive-skip drops the in-flight orphan token.
        Engines that have never seen a deadline pay one int compare."""
        if not self._deadline_count:
            return
        now = time.monotonic()
        for seq in self.scheduler.expire_waiting(now):
            self._record_expiry(seq, "queued")
            self._finished(seq)
        for seq in self.scheduler.expired_running(now):
            self.scheduler.finish(seq, FINISH_EXPIRED)
            self._record_expiry(seq, "running")
            self._finished(seq)

    def _record_expiry(self, seq: Sequence, phase: str) -> None:
        self._expired_total += 1
        self._expired_count.inc(tags=self._metric_tags)
        rt = self._req_traces.get(seq.request.request_id)
        if rt is not None:
            rt.error = "deadline expired"
        self.flight_recorder.record_expiry(
            seq.request.request_id, phase, self._steps, len(seq.generated)
        )

    def close_traces(self, exc: BaseException) -> None:
        """Close every in-flight request's trace with error status (the
        wedge and shutdown broadcasts end requests WITHOUT _finished())."""
        now = time.time()
        error = repr(exc)
        for rid, rt in list(self._req_traces.items()):
            rt.error = error
            seq = self.scheduler._active.get(rid)
            if seq is not None:
                rt.on_finish(now, seq)
        self._req_traces.clear()

    # ---------------- stepping ----------------

    def step(self) -> dict:
        """One engine iteration: admit prefills, feed each in-flight
        prompt its next chunk under the per-step token budget, decode
        every decode-ready sequence one token, emit tokens, retire
        finished sequences. A sequence mid-chunk stays `prefilling` — it
        never enters the decode batch, so a chunk failure (or a step
        retry) simply re-plans from its committed num_cached."""
        if self._async:
            return self._step_async()
        ecfg = self.engine_config
        preempted_before = self.scheduler.num_preemptions
        self._current_rid = None
        maybe_fail("llm.step")
        instrument = self._instrument
        # Wall clock for record identity ("time" field), perf_counter for
        # the duration.
        t_step = time.time() if instrument else 0.0
        t_step_p = time.perf_counter() if instrument else 0.0
        bytes_before = self._host_transfer_bytes() if instrument else 0
        self._step_gap = None
        self._step_dispatch_wall = None
        self._step_commits = []
        self._step_ready_wall = None
        self._step_prefill_s = 0.0
        self._step_fabric_wait_s = 0.0

        # Deadline sweep BEFORE admission: a queued request whose deadline
        # passed must never reach schedule_prefills.
        self._expire_deadlines()
        admitted = self.scheduler.schedule_prefills(
            ecfg.max_prefills_per_step
        )
        # KV-fabric restores commit BETWEEN admission and chunk planning:
        # each committed block advances its sequence's num_cached, so the
        # chunk plan below (and the first chunk's hit-token accounting,
        # which reads the offset) already sees the restored prefix.
        step_restored = 0
        if self._fabric is not None:
            step_restored = self._apply_fabric_restores(admitted)
        # Mixed-step dispatch: this step's chunk plan spans newly admitted
        # prompts AND prompts already mid-prefill from earlier steps,
        # oldest first, capped by the token budget (None = whole prompts).
        plans = self.scheduler.schedule_prefill_chunks(self._prefill_budget)
        prefill_info: List[dict] = []
        step_hit_tokens = self._run_prefill_chunks(plans, prefill_info)

        decoding = self.scheduler.schedule_decode()
        spec_info: Optional[dict] = None
        if decoding:
            if self._spec is not None:
                spec_info = self._run_verify(decoding)
            if spec_info is None:
                # Speculation off, or no sequence had proposals this step:
                # the plain decode program is exactly equivalent for one
                # fed token per slot.
                self._run_decode(decoding)
        else:
            # No decode this step: the next dispatch follows an idle
            # stretch, not host scheduling work — don't count it as gap.
            self._last_ready_t = None

        self._steps += 1
        preempted, occupancy, backlog = self._step_gauges(
            preempted_before, step_hit_tokens, decoding
        )
        if instrument:
            decode_label = "verify" if spec_info is not None else "decode"
            phase = "+".join(
                p
                for p, on in (("prefill", plans), (decode_label, decoding))
                if on
            ) or "idle"
            record = {
                "step": self._steps - 1,
                "phase": phase,
                "attn_impl": self._attn_impl,
                "tensor_parallel_size": self._tp,
                # Explicit host<->device bytes this step moved (program
                # inputs + sampled tokens, target AND draft runner).
                "host_transfer_bytes": (
                    self._host_transfer_bytes() - bytes_before
                ),
                "batch_size": len(decoding),
                "num_prefills": len(plans),
                "prefills": prefill_info,
                # With chunking on, tokens_in (the prompt tokens fed
                # this step) never exceeds prefill_budget.
                "tokens_in": sum(p["tokens"] for p in prefill_info),
                "prefill_budget": self._prefill_budget,
                "prefill_backlog_tokens": backlog,
                "tokens_out": sum(1 for p in prefill_info if p["final"])
                + (
                    spec_info["emitted"]
                    if spec_info is not None
                    else len(decoding)
                ),
                "cache_hit_tokens": step_hit_tokens,
                "preempted": preempted,
                "queue_depth": len(self.scheduler.waiting),
                "duration_s": round(time.perf_counter() - t_step_p, 6),
                "time": t_step,
                "dispatch_time": self._step_dispatch_wall,
                "commits": self._step_commits,
                "host_gap_s": self._step_gap,
                "ready_time": self._step_ready_wall,
                "prefill_s": round(self._step_prefill_s, 6),
                "fabric_wait_s": round(self._step_fabric_wait_s, 6),
            }
            if spec_info is not None:
                # Verify record: which proposer ran, how wide the fed
                # bucket was, and the proposed/accepted/emitted counts.
                record["speculation"] = spec_info
            if self._fabric is not None:
                record["fabric_restored_blocks"] = step_restored
            self.flight_recorder.record_step(record)
        return self._step_result(
            plans, decoding, occupancy, preempted, step_hit_tokens, backlog
        )

    def _step_gauges(self, preempted_before, step_hit_tokens, decoding):
        """The per-step metric updates both loops share → (preempted,
        occupancy, prefill backlog tokens)."""
        ecfg = self.engine_config
        # A stepping engine exports its whole metric family: counters and
        # histograms that happen not to fire after a registry reset must
        # still re-register, or their series vanish from the exposition.
        family = (
            self._preemptions, self._prefix_hits, self._tokens_generated,
            self._dead_letter_count, self._shed_count, self._expired_count,
            self._h_ttft, self._h_tpot,
            self._h_queue, self._h_e2e, self._h_step, self._h_host_gap,
        )
        if self._spec is not None:
            family = family + (
                self._spec_proposed, self._spec_accepted,
                self._spec_acceptance,
            )
        if self._fabric is not None:
            family = family + (
                self._fabric_spills, self._fabric_restores,
                self._fabric_hits, self._fabric_hit_rate,
                self._fabric_bytes_used, self._fabric_timeouts,
            )
        for metric in family:
            metric._ensure_registered()
        preempted = self.scheduler.num_preemptions - preempted_before
        if preempted:
            self._preemptions.inc(preempted, tags=self._metric_tags)
        if step_hit_tokens:
            self._cache_hit_tokens += step_hit_tokens
            self._prefix_hits.inc(step_hit_tokens, tags=self._metric_tags)
        occupancy = len(decoding) / ecfg.max_decode_slots
        self._occupancy.set(occupancy, tags=self._metric_tags)
        self._cache_util.set(self.allocator.utilization(), tags=self._metric_tags)
        self._queue_depth.set(len(self.scheduler.waiting), tags=self._metric_tags)
        self._prefix_hit_rate.set(
            self._cache_hit_tokens / max(self._prefill_tokens, 1),
            tags=self._metric_tags,
        )
        self._evictable_blocks.set(
            self.allocator.num_evictable, tags=self._metric_tags
        )
        if self._fabric is not None:
            self._fabric_hit_rate.set(
                self._fabric_restored_tokens / max(self._prefill_tokens, 1),
                tags=self._metric_tags,
            )
        backlog = self.scheduler.prefill_backlog_tokens()
        self._prefill_backlog.set(backlog, tags=self._metric_tags)
        return preempted, occupancy, backlog

    def _step_result(
        self, plans, decoding, occupancy, preempted, step_hit_tokens, backlog
    ) -> dict:
        return {
            "num_prefilled": len(plans),
            "num_decoding": len(decoding),
            "occupancy": occupancy,
            "cache_utilization": self.allocator.utilization(),
            "queue_depth": len(self.scheduler.waiting),
            "preempted": preempted,
            "cache_hit_tokens": step_hit_tokens,
            "evictable_blocks": self.allocator.num_evictable,
            "prefill_backlog_tokens": backlog,
        }

    def _host_transfer_bytes(self) -> int:
        """Cumulative explicit host<->device bytes across the target
        runner AND the draft-model runner: the per-step delta rides the
        flight records."""
        total = self.runner.host_transfer_bytes()
        spec_runner = getattr(self._spec, "runner", None)
        if spec_runner is not None:
            total += spec_runner.host_transfer_bytes()
        return total

    # ---------------- KV fabric ----------------

    def _note_fabric_timeout(self) -> None:
        """KVFabricClient on_timeout hook: one store RPC exceeded its
        bound and degraded to a miss/no-op."""
        self._fabric_timeout_total += 1
        self._fabric_timeouts.inc(tags=self._metric_tags)

    def _apply_fabric_restores(self, admitted: List[Sequence]) -> int:
        """Resolve each newly admitted sequence's fabric restore plan
        (Scheduler._admit probed the fabric and pre-allocated the target
        slots): fetch the planned chain of payloads in one batch RPC and
        commit them in chain order — copy the content into the slot FIRST,
        then advance num_cached and register the chain key, so a
        half-written block is never discoverable under its key. The chain
        stops at the first miss or failed copy-in; the remaining slots
        simply stay plain prefill targets (they are already legitimate
        members of the block table, and num_cached never claimed them).
        Returns blocks restored."""
        bs = self.engine_config.block_size
        restored = 0
        hit_blocks = 0
        t_fabric = time.perf_counter() if self._instrument else 0.0
        for seq in admitted:
            plan = seq.pending_restore
            if not plan:
                continue
            seq.pending_restore = []
            self._current_rid = seq.request.request_id
            hit_blocks += len(plan)
            payloads = self._fabric.get_many([h for _, h in plan])
            for (block, h), payload in zip(plan, payloads):
                if payload is None:
                    break  # chain broken: later blocks cannot commit either
                try:
                    self.runner.restore_block(block, payload)
                except Exception:
                    break  # failed copy-in: the slot stays a prefill target
                seq.num_cached += bs
                seq.block_hashes.append(h)
                self.allocator.register(block, h)
                restored += 1
                self._fabric_restored_tokens += bs
        self._current_rid = None
        if hit_blocks:
            self._fabric_hit_total += hit_blocks
            self._fabric_hits.inc(hit_blocks, tags=self._metric_tags)
        if restored:
            self._fabric_restored_total += restored
            self._fabric_restores.inc(restored, tags=self._metric_tags)
        if self._instrument:
            # Wall this step spent blocked on fabric store RPCs + block
            # copy-ins: the ledger's fabric-wait column.
            self._step_fabric_wait_s = time.perf_counter() - t_fabric
        return restored

    def _spill_block(self, block: int, block_hash: int) -> None:
        """BlockAllocator.on_evict hook: demote the dying block's device
        content to the fabric's host tier, keyed by its chain hash. Best
        effort end to end — the allocator contains hook exceptions and
        the client degrades to a no-op — so eviction always completes.
        Runs inside admission; under async_scheduling the block copy waits
        for the step in flight (the block itself is unreferenced, so that
        step does not write it)."""
        if self._fabric.put(block_hash, self.runner.extract_block(block)):
            self._fabric_spilled_total += 1
            self._fabric_spills.inc(tags=self._metric_tags)

    def flush_kv_fabric(self) -> int:
        """Demote every cached-but-unreferenced device block into the
        fabric in one batch RPC — the drain path's cache preservation:
        a victim replica's reusable prefixes survive as fabric entries
        instead of dying with the engine. Returns how many of the flushed
        blocks are resident afterwards; 0 without a fabric."""
        if self._fabric is None:
            return 0
        items = [
            (h, self.runner.extract_block(block))
            for block, h in self.allocator.evictable_items()
        ]
        n = self._fabric.put_many(items)
        if n:
            self._fabric_spilled_total += n
            self._fabric_spills.inc(n, tags=self._metric_tags)
        return n

    def _run_decode(self, decoding: List[Sequence]) -> None:
        """One iteration-level decode dispatch: every running sequence
        advances exactly one token through the batched decode program."""
        ecfg = self.engine_config
        instrument = self._instrument
        t_decode = time.perf_counter() if instrument else 0.0
        self._fill_decode_inputs(decoding)
        self._note_dispatch(pipelined=False)
        next_tokens = self.runner.decode(
            self._dec_tokens, self._dec_positions, self._dec_block_tables,
            self._dec_context_lens,
        )
        # decode() returned == the program ran and its tokens are on
        # host: everything until the next dispatch is host-side gap.
        self._last_ready_t = time.perf_counter()
        if instrument:
            self._step_ready_wall = time.time()
        for i, seq in enumerate(decoding):
            # Per-sequence section; placed before any mutation so a
            # failure here leaves this sequence (and every later one,
            # whose decode simply re-runs from unchanged state next
            # step) consistent.
            self._current_rid = seq.request.request_id
            maybe_fail("llm.decode.seq", detail=seq.request.request_id)
            seq.num_cached += 1
            seq.generated.append(int(next_tokens[i]))
            if seq.num_cached % ecfg.block_size == 0:
                # A block just filled: publish it to the prefix cache
                # before a finish below could release it.
                self.scheduler.note_filled_blocks(seq)
            self._emit(seq)
            self._maybe_finish(seq)
        self._current_rid = None
        self._decode_tokens += len(decoding)
        self._decode_slot_steps += ecfg.max_decode_slots
        self._step_commits.append(
            {
                "dispatch_step": self._steps,
                "time": time.time(),
                "tokens": len(decoding),
                "commit_s": round(
                    time.perf_counter() - self._last_ready_t, 6
                ),
            }
        )
        if instrument:
            # One observation per batched decode dispatch, never per token.
            self._h_step.observe(
                time.perf_counter() - t_decode,
                tags=self._step_tags["decode"],
            )

    def _fill_decode_inputs(self, decoding: List[Sequence]) -> None:
        """Zero-fill and repopulate the preallocated decode inputs from
        fully committed state (never allocate)."""
        tokens = self._dec_tokens
        positions = self._dec_positions
        block_tables = self._dec_block_tables
        context_lens = self._dec_context_lens
        tokens.fill(0)
        positions.fill(0)
        block_tables.fill(0)
        context_lens.fill(0)
        for i, seq in enumerate(decoding):
            tokens[i] = seq.last_token
            positions[i] = seq.num_cached
            block_tables[i, : len(seq.block_table)] = seq.block_table
            context_lens[i] = seq.num_cached

    def _run_verify(self, decoding: List[Sequence]) -> Optional[dict]:
        """Speculative verify phase: ask the proposer for up to k tokens
        per running sequence, score them all in ONE target-model step
        (GPTRunner.verify — the partial-prefill shape batched over the
        decode slots), accept each sequence's longest proposal prefix that
        agrees with the target argmax plus the correction/bonus token, and
        roll back the rejected tail (Scheduler.rollback: context-length
        rewind + block-table trim). Emits 1..k+1 tokens per sequence per
        step; greedy outputs are token-identical to the plain decode loop
        by construction (out[i] IS the token decode would have produced).

        Returns the flight-recorder speculation record, or None when no
        sequence had usable proposals this step — the caller then runs the
        plain decode program, which is exactly equivalent for one fed
        token per slot."""
        ecfg = self.engine_config
        instrument = self._instrument
        # Clock starts before the proposer: proposal cost (draft-model
        # steps, host-side matching) is part of what the verify phase
        # must amortize, so it belongs in the phase=verify histogram.
        t_verify = time.perf_counter() if instrument else 0.0
        k = ecfg.num_speculative_tokens
        proposals = self._spec.propose(decoding, k)
        plans: List[List[int]] = []
        max_fed = 1
        for seq, props in zip(decoding, proposals):
            props = [int(t) for t in props[:k]]
            # Never speculate past the request budget (the bonus token
            # must still fit) or the cache capacity; blocks are reserved
            # opportunistically — speculation never preempts a neighbor.
            cap = min(
                len(props),
                seq.request.max_new_tokens - len(seq.generated) - 1,
                ecfg.max_model_len - seq.num_cached - 1,
            )
            props = props[: max(cap, 0)]
            if props:
                props = props[
                    : self.scheduler.reserve_speculative(seq, len(props))
                ]
            plans.append(props)
            max_fed = max(max_fed, 1 + len(props))
        if max_fed == 1:
            return None
        s_bucket = ecfg.verify_bucket_for(max_fed)
        # Preallocated per-bucket input buffers (zero-fill + repopulate);
        # reuse is safe — runner.verify returns after its tokens are on
        # the host.
        tokens, block_tables, context_lens, true_lens = self._verify_inputs[
            s_bucket
        ]
        tokens.fill(0)
        block_tables.fill(0)
        context_lens.fill(0)
        true_lens.fill(0)
        for i, (seq, props) in enumerate(zip(decoding, plans)):
            tokens[i, 0] = seq.last_token
            if props:
                tokens[i, 1 : 1 + len(props)] = props
            block_tables[i, : len(seq.block_table)] = seq.block_table
            context_lens[i] = seq.num_cached
            true_lens[i] = 1 + len(props)
        self._note_dispatch(pipelined=False)
        out = self.runner.verify(
            tokens, block_tables, context_lens, true_lens
        )
        self._last_ready_t = time.perf_counter()
        if instrument:
            self._step_ready_wall = time.time()
        proposed = accepted = emitted = 0
        for i, (seq, props) in enumerate(zip(decoding, plans)):
            # Per-sequence commit section; nothing mutates before the
            # injection point, so a poisoned request dead-letters alone
            # and an unattributable failure retries the whole step from
            # consistent state (propose() is deterministic on retry).
            rid = seq.request.request_id
            self._current_rid = rid
            maybe_fail("engine.verify", detail=rid)
            base = seq.num_cached
            n_ok = 0
            while n_ok < len(props) and int(out[i, n_ok]) == props[n_ok]:
                n_ok += 1
            # out[i, n_ok] is the correction after a mismatch, or the
            # bonus token when every proposal matched — either way the
            # target's own argmax, so it is always committed.
            new_tokens = props[:n_ok] + [int(out[i, n_ok])]
            eos_id = seq.request.eos_id
            if eos_id is not None and eos_id in new_tokens:
                new_tokens = new_tokens[: new_tokens.index(eos_id) + 1]
            self.scheduler.rollback(seq, base + len(new_tokens))
            seq.generated.extend(new_tokens)
            self.scheduler.note_filled_blocks(seq)
            proposed += len(props)
            # Accepted = proposed tokens actually COMMITTED: an eos inside
            # the matched prefix truncates the commit, and the counter
            # must not claim the dropped tail.
            accepted += min(n_ok, len(new_tokens))
            emitted += len(new_tokens)
            self._emit(seq)
            self._maybe_finish(seq)
        self._current_rid = None
        self._decode_tokens += emitted
        self._decode_slot_steps += ecfg.max_decode_slots
        self._step_commits.append(
            {
                "dispatch_step": self._steps,
                "time": time.time(),
                "tokens": emitted,
                "commit_s": round(
                    time.perf_counter() - self._last_ready_t, 6
                ),
            }
        )
        self._verify_steps += 1
        self._spec_proposed_total += proposed
        self._spec_accepted_total += accepted
        self._spec_emitted_total += emitted
        if proposed:
            self._spec_proposed.inc(proposed, tags=self._metric_tags)
        if accepted:
            self._spec_accepted.inc(accepted, tags=self._metric_tags)
        self._spec_acceptance.set(
            self._spec_accepted_total / max(self._spec_proposed_total, 1),
            tags=self._metric_tags,
        )
        if instrument:
            # One observation per batched verify dispatch (proposer +
            # program + the whole commit loop), never per token.
            self._h_step.observe(
                time.perf_counter() - t_verify,
                tags=self._step_tags["verify"],
            )
        return {
            "mode": self._spec.name,
            "fed_bucket": s_bucket,
            "proposed": proposed,
            "accepted": accepted,
            "emitted": emitted,
        }

    # ---------------- async (double-buffered) stepping ----------------

    def _note_dispatch(self, pipelined: bool) -> None:
        """Host-gap sample at a decode/verify device dispatch: how long
        the previous step's results had been host-readable before this
        program was queued — the device idle window host scheduling
        opened. A chained async dispatch is issued BEFORE the previous
        step's results are even fetched, so it records exactly 0 (the
        gap definition's clamp: the dispatch beat the fetch)."""
        self._step_dispatch_wall = time.time()
        if pipelined:
            gap = 0.0
        else:
            if self._last_ready_t is None:
                return  # first dispatch / post-idle: no previous step
            gap = max(0.0, time.perf_counter() - self._last_ready_t)
        self._step_gap = gap
        self._host_gap_total += gap
        self._host_gap_count += 1
        self._host_gap_last = gap
        self._h_host_gap.observe(gap, tags=self._metric_tags)

    def _step_async(self) -> dict:
        """One iteration of the async step loop (EngineConfig.
        async_scheduling): decode splits into a dispatch phase and a
        deferred commit phase, pipelined one step deep.

        Steady state CHAINS: the in-flight decode's on-device tokens feed
        the next dispatch directly (positions and context_lens advance +1
        — deterministic, value-free), THEN the in-flight step's values are
        fetched and committed one step behind, so the device is already
        running step N+1 while the host emits step N's tokens and plans
        admissions. Everything value-dependent is a pipeline-flush
        boundary (commit everything, then schedule normally): speculation
        (the proposer reads committed token history), any
        batch-composition change (finish / abort / preemption / a prompt
        joining — the chained token input is slot-aligned), block pressure
        the lookahead cannot cover without preempting (preemption must
        never run under an in-flight write), and a partially committed
        record left by a poison retry.

        Finishes are detected one step late, at commit: a chained
        dispatch may decode one token PAST a sequence's EOS/length stop.
        That overshoot token lands in the null block or a lookahead block
        freed with the sequence, is skipped at its record's commit, and
        never reaches a client. Greedy outputs are token-identical to the
        sync loop across every feature knob."""
        ecfg = self.engine_config
        preempted_before = self.scheduler.num_preemptions
        self._current_rid = None
        maybe_fail("llm.step")
        instrument = self._instrument
        t_step = time.time() if instrument else 0.0
        t_step_p = time.perf_counter() if instrument else 0.0
        bytes_before = self._host_transfer_bytes() if instrument else 0
        self._step_gap = None
        self._step_dispatch_wall = None
        self._step_commits = []
        self._step_ready_wall = None
        self._step_prefill_s = 0.0
        self._step_fabric_wait_s = 0.0

        # Deadline sweep before the chain attempt: an expiry changes the
        # batch composition, so _try_chain refuses and the pipeline
        # flushes — the expired sequence's in-flight token is dropped by
        # _commit_head's inactive-skip, never emitted.
        self._expire_deadlines()
        # Chained dispatch FIRST — before any commit, admission, or
        # metric work: the whole point is that the device gets its next
        # program while the host still owes this step's bookkeeping. A
        # record mid-partial-commit (poison retry) or a second in-flight
        # record never chains; both flush below.
        chained_seqs: Optional[List[Sequence]] = None
        if (
            self._spec is None
            and len(self._inflight) == 1
            and self._inflight[0].commit_idx == 0
        ):
            chained_seqs = self._try_chain(self._inflight[0])
        if chained_seqs is not None:
            # Commit the record the chain fed from (its host copy has been
            # in flight since its dispatch); the chained record stays in
            # flight for the next iteration.
            self._commit_head()
        else:
            # Flush boundary: commit everything in dispatch order, then
            # schedule normally from fully committed state.
            while self._inflight:
                self._commit_head()

        admitted = self.scheduler.schedule_prefills(
            ecfg.max_prefills_per_step
        )
        # Restores run after the flush boundary or beside a chained decode
        # still in flight. They write only slots the admission just
        # allocated, which no in-flight step reads or writes, and the
        # copy-in is queued on the same stream after that step, so stream
        # order is all the ordering they need.
        step_restored = 0
        if self._fabric is not None:
            step_restored = self._apply_fabric_restores(admitted)
        plans = self.scheduler.schedule_prefill_chunks(self._prefill_budget)
        prefill_info: List[dict] = []
        step_hit_tokens = self._run_prefill_chunks(plans, prefill_info)

        spec_info: Optional[dict] = None
        dispatched = chained_seqs is not None
        if chained_seqs is not None:
            decoding = chained_seqs
        else:
            decoding = self.scheduler.schedule_decode()
            if decoding:
                if self._spec is not None:
                    # Speculation composes as flush-every-step: acceptance
                    # is value-dependent, so the verify path runs the sync
                    # dispatch+commit inline (still token-identical).
                    spec_info = self._run_verify(decoding)
                    if spec_info is None:
                        self._run_decode(decoding)
                else:
                    self._dispatch_decode_async(decoding)
                    dispatched = True
            else:
                self._last_ready_t = None

        self._steps += 1
        preempted, occupancy, backlog = self._step_gauges(
            preempted_before, step_hit_tokens, decoding
        )
        committed_tokens = sum(c["tokens"] for c in self._step_commits)
        if instrument:
            decode_label = "verify" if spec_info is not None else "decode"
            parts = []
            if plans:
                parts.append("prefill")
            if spec_info is not None or (decoding and not dispatched):
                parts.append(decode_label)
            elif dispatched:
                parts.append("decode")
            elif self._step_commits:
                # Drain-only iteration: nothing dispatched, but a stale
                # in-flight record committed (e.g. every member finished
                # or aborted since its dispatch).
                parts.append("commit")
            record = {
                "step": self._steps - 1,
                "loop": "async",
                "phase": "+".join(parts) or "idle",
                "attn_impl": self._attn_impl,
                "tensor_parallel_size": self._tp,
                "host_transfer_bytes": (
                    self._host_transfer_bytes() - bytes_before
                ),
                "batch_size": len(decoding),
                "num_prefills": len(plans),
                "prefills": prefill_info,
                "tokens_in": sum(p["tokens"] for p in prefill_info),
                "prefill_budget": self._prefill_budget,
                "prefill_backlog_tokens": backlog,
                # Async semantics: tokens_out counts tokens COMMITTED
                # this iteration (prefill finals + deferred decode
                # commits) — a dispatched-but-uncommitted token is not
                # out yet.
                "tokens_out": sum(1 for p in prefill_info if p["final"])
                + (
                    spec_info["emitted"]
                    if spec_info is not None
                    else committed_tokens
                ),
                "cache_hit_tokens": step_hit_tokens,
                "preempted": preempted,
                "queue_depth": len(self.scheduler.waiting),
                "duration_s": round(time.perf_counter() - t_step_p, 6),
                "time": t_step,
                "dispatch_time": self._step_dispatch_wall,
                "commits": self._step_commits,
                "host_gap_s": self._step_gap,
                "ready_time": self._step_ready_wall,
                "prefill_s": round(self._step_prefill_s, 6),
                "fabric_wait_s": round(self._step_fabric_wait_s, 6),
                "chained": chained_seqs is not None,
                "inflight_depth": len(self._inflight),
            }
            if spec_info is not None:
                record["speculation"] = spec_info
            if self._fabric is not None:
                record["fabric_restored_blocks"] = step_restored
            self.flight_recorder.record_step(record)
        return self._step_result(
            plans, decoding, occupancy, preempted, step_hit_tokens, backlog
        )

    def _try_chain(self, rec: _InflightStep) -> Optional[List[Sequence]]:
        """Chain the in-flight decode into the next dispatch if — and
        only if — the next decode batch would be EXACTLY the dispatched
        batch (same sequences, same slot order: the chained token input
        is slot-aligned on device) AND every +1-position write can be
        covered without preempting anyone (reserve_decode_lookahead).
        On success the chained program is already dispatched when this
        returns; on any mismatch returns None and the caller flushes."""
        for seq, rid in zip(rec.seqs, rec.rids):
            if (
                not seq.is_running
                or seq.prefilling
                or not self.scheduler.is_active(rid)
            ):
                return None
        current = [s for s in self.scheduler.running if not s.prefilling]
        if len(current) != len(rec.seqs) or any(
            a is not b for a, b in zip(current, rec.seqs)
        ):
            return None
        if not self.scheduler.reserve_decode_lookahead(rec.seqs):
            return None
        self._dispatch_chained(rec)
        return rec.seqs

    def _dispatch_chained(self, rec: _InflightStep) -> None:
        """Dispatch the next decode with the in-flight step's on-device
        tokens as input — no host sync anywhere on this path. The
        in-flight token for slot i has not committed yet, so its write
        position is num_cached + 1 and its context covers num_cached + 1
        tokens; both advance deterministically without knowing the
        token's value. Unused slots carry whatever the previous program
        sampled — they scatter into the null block exactly like the sync
        path's zero padding."""
        self._note_dispatch(pipelined=True)
        positions = self._dec_positions
        block_tables = self._dec_block_tables
        context_lens = self._dec_context_lens
        positions.fill(0)
        block_tables.fill(0)
        context_lens.fill(0)
        for i, seq in enumerate(rec.seqs):
            positions[i] = seq.num_cached + 1
            block_tables[i, : len(seq.block_table)] = seq.block_table
            context_lens[i] = seq.num_cached + 1
        tokens_dev = self.runner.decode_async(
            rec.tokens_dev, positions, block_tables, context_lens
        )
        self._inflight.append(
            _InflightStep(rec.seqs, rec.rids, tokens_dev, self._steps)
        )

    def _dispatch_decode_async(self, decoding: List[Sequence]) -> None:
        """Fresh async dispatch from fully committed state (pipeline
        start / after a flush): inputs build exactly like _run_decode,
        but the runner queues the device-to-host copy instead of
        blocking — the commit runs one step later (_commit_head)."""
        self._fill_decode_inputs(decoding)
        self._note_dispatch(pipelined=False)
        tokens_dev = self.runner.decode_async(
            self._dec_tokens, self._dec_positions, self._dec_block_tables,
            self._dec_context_lens,
        )
        self._inflight.append(
            _InflightStep(
                list(decoding),
                [s.request.request_id for s in decoding],
                tokens_dev,
                self._steps,
            )
        )

    def _commit_head(self) -> None:
        """Fetch and commit the OLDEST in-flight record — the deferred
        half of a dispatch made one iteration ago. The commit loop is the
        sync path's, one step late: per-sequence poison site, num_cached
        advance, block publication, emission, finish detection.
        Sequences that went inactive since dispatch (finished at the
        previous commit, aborted, preempted on a flush) are skipped —
        their fetched token is the EOS/length overshoot or an orphan, and
        it is dropped before any emission. On a mid-loop exception the
        record stays at the head with commit_idx advanced past the
        already-committed slots, so the server's step retry resumes the
        commit exactly where it stopped; failure_step() attributes the
        exception against this record's DISPATCH index."""
        rec = self._inflight[0]
        ecfg = self.engine_config
        instrument = self._instrument
        t0 = time.perf_counter() if instrument else 0.0
        self._attribution_step = rec.dispatch_step
        if rec.tokens_host is None:
            # Wait for this step's event only (usually long done — the
            # copy has been in flight since dispatch). A failed decode
            # PROGRAM surfaces here, one step after dispatch, attributed
            # above.
            rec.tokens_host = rec.tokens_dev.fetch()
            self._last_ready_t = time.perf_counter()
            if instrument:
                self._step_ready_wall = time.time()
        next_tokens = rec.tokens_host
        committed = 0
        while rec.commit_idx < len(rec.seqs):
            i = rec.commit_idx
            seq = rec.seqs[i]
            if (
                not seq.is_running
                or seq.prefilling
                or not self.scheduler.is_active(rec.rids[i])
            ):
                rec.commit_idx += 1
                continue
            self._current_rid = rec.rids[i]
            maybe_fail("llm.decode.seq", detail=rec.rids[i])
            seq.num_cached += 1
            seq.generated.append(int(next_tokens[i]))
            if seq.num_cached % ecfg.block_size == 0:
                self.scheduler.note_filled_blocks(seq)
            rec.commit_idx += 1
            committed += 1
            self._emit(seq)
            self._maybe_finish(seq)
        self._current_rid = None
        self._attribution_step = None
        self._inflight.popleft()
        self._decode_tokens += committed
        self._decode_slot_steps += ecfg.max_decode_slots
        self._step_commits.append(
            {
                "dispatch_step": rec.dispatch_step,
                "time": time.time(),
                "tokens": committed,
                "commit_s": (
                    round(time.perf_counter() - t0, 6)
                    if instrument
                    else None
                ),
            }
        )
        if instrument:
            # The async decode series measures the commit half (fetch +
            # emission loop) — the dispatch half is what the chain hides.
            self._h_step.observe(
                time.perf_counter() - t0, tags=self._step_tags["decode"]
            )

    def _run_prefill_chunks(
        self,
        plans: List[tuple],
        info_out: Optional[List[dict]] = None,
    ) -> int:
        """Run this step's prefill chunk plan ((sequence, token count)
        pairs from Scheduler.schedule_prefill_chunks); returns the prompt
        tokens served from the prefix cache this step. Each chunk commits
        independently (num_cached advances only after its program
        returns), so a failure mid-plan leaves every sequence consistent.
        Only the FINAL chunk of a prompt produces a token; continuation
        chunks just stream K/V into the cache. With instrumentation,
        `info_out` collects one record per chunk for the flight recorder."""
        instrument = self._instrument
        hit_tokens = 0
        t_plan = time.perf_counter() if (instrument and plans) else 0.0
        for seq, take in plans:
            # Per-sequence section: an exception below is attributable to
            # this request (LLMServer._loop fails only it and keeps going).
            rid = seq.request.request_id
            self._current_rid = rid
            first_chunk = seq.num_chunks == 0
            final = take >= seq.prefill_len - seq.num_cached
            if first_chunk:
                maybe_fail("llm.prefill", detail=rid)
            maybe_fail("engine.prefill_chunk", detail=rid)
            offset = seq.num_cached  # cache-matched prefix + prior chunks
            rt = queue_wait = None
            if instrument:
                t0 = time.time()
                rt = self._req_traces.get(rid)
                if rt is not None and rt.queue_start is not None:
                    # The queue ends when the request's FIRST chunk starts
                    # computing (one wait per admission).
                    queue_wait = rt.on_admitted(t0)
            was_cow = seq.pending_copy is not None
            if was_cow:
                # Copy-on-write: the last matched block is shared and this
                # prefill writes its final token's K/V into it. pending_copy
                # is cleared only AFTER the device copy lands and the
                # copy-source ref is dropped, so a failing copy still
                # releases src through _release.
                src, dst = seq.pending_copy
                self.runner.copy_block(src, dst)
                self.allocator.free([src])  # drop admission's copy-source ref
                seq.pending_copy = None
            chunk_ids = seq.prefill_ids[offset : offset + take]
            if offset > 0:
                tok = self.runner.prefill_suffix(
                    chunk_ids, seq.block_table, offset
                )
                if first_chunk:
                    hit_tokens += offset
            else:
                # First chunk from a cold cache: the full-prefill program
                # for this chunk's bucket, over the blocks the chunk fills.
                tok = self.runner.prefill(
                    chunk_ids,
                    seq.block_table[
                        : blocks_for_tokens(
                            take, self.engine_config.block_size
                        )
                    ],
                )
            self._prefill_tokens += take
            self._prefill_chunk_dispatches += 1
            seq.num_cached = offset + take
            seq.num_chunks += 1
            if final and seq.num_chunks > 1:
                self._chunked_prefill_requests += 1
            # Publish every block this chunk filled: a concurrent request
            # with the same prompt can share the prefix before the whole
            # prompt even finishes prefilling.
            pre_hashes = len(seq.block_hashes)
            self.scheduler.note_filled_blocks(seq)
            if self._publish_on_fill and len(seq.block_hashes) > pre_hashes:
                # Prefill-role handoff: push this chunk's just-filled
                # blocks to the fabric NOW, so they are resident before
                # the request's reply (the barrier the decode-role
                # engine's admission relies on) can possibly seal.
                pushed = self._fabric.put_many(
                    [
                        (
                            seq.block_hashes[j],
                            self.runner.extract_block(seq.block_table[j]),
                        )
                        for j in range(pre_hashes, len(seq.block_hashes))
                    ]
                )
                if pushed:
                    self._fabric_spilled_total += pushed
                    self._fabric_spills.inc(
                        pushed, tags=self._metric_tags
                    )
            if final:
                seq.generated.append(tok)
            if instrument:
                t1 = time.time()
                kind = "cow" if was_cow else ("partial" if offset else "full")
                phase = "partial_prefill" if offset else "prefill"
                bucket = self.engine_config.bucket_for(max(take, 1))
                # ray-tpu: lint-ignore[RTL302] t0/t1 double as span
                # timestamps (wall-clock identity across actors); the
                # histogram delta rides on the same pair
                self._h_step.observe(
                    t1 - t0,
                    tags=(
                        self._step_tags[phase]
                        if final
                        else self._chunk_step_tags[phase]
                    ),
                )
                if queue_wait is not None:
                    self._h_queue.observe(
                        queue_wait, tags=self._metric_tags
                    )
                if rt is not None:
                    first_admission = rt.first_token_s is None
                    rt.on_prefilled(
                        t0, t1, kind, bucket, take, offset,
                        len(seq.generated),
                        chunk=seq.num_chunks - 1, final=final,
                    )
                    if final and first_admission:
                        # TTFT observes exactly once per request: at the
                        # final chunk of its FIRST admission.
                        self._h_ttft.observe(
                            t1 - rt.submit_s, tags=self._metric_tags
                        )
                if info_out is not None:
                    info_out.append(
                        {
                            "request_id": rid,
                            "kind": kind,
                            "bucket": bucket,
                            "tokens": take,
                            "cached_tokens": offset,
                            "chunk": seq.num_chunks - 1,
                            "final": final,
                        }
                    )
            if final:
                self._emit(seq)
                self._maybe_finish(seq)
        self._current_rid = None
        if instrument and plans:
            self._step_prefill_s = time.perf_counter() - t_plan
        return hit_tokens

    def _emit(self, seq: Sequence) -> None:
        cb = self._on_token.get(seq.request.request_id)
        while seq.emitted < len(seq.generated):
            token = seq.generated[seq.emitted]
            seq.emitted += 1
            self._tokens_generated.inc(tags=self._metric_tags)
            if cb is not None:
                cb(token)

    def _maybe_finish(self, seq: Sequence) -> None:
        req = seq.request
        reason = None
        if req.eos_id is not None and seq.generated[-1] == req.eos_id:
            reason = FINISH_EOS
        elif len(seq.generated) >= req.max_new_tokens:
            reason = FINISH_LENGTH
        if reason is not None:
            self.scheduler.finish(seq, reason)
            self._finished(seq)

    def _note_preempt(self, seq: Sequence) -> None:
        """Scheduler preemption hook: drop the proposer's per-request
        state (a stateful proposer's draft blocks must not outlive the
        victim's own KV blocks — the resume re-prefills both caches),
        then close the victim's decode-stretch span, mark the preemption,
        and restart its queue-wait clock."""
        if self._spec is not None:
            self._spec.release(seq.request.request_id)
        rt = self._req_traces.get(seq.request.request_id)
        if rt is not None:
            rt.on_preempt(time.time(), len(seq.generated))

    def _finished(self, seq: Sequence) -> None:
        req_id = seq.request.request_id
        if seq.request.deadline_s is not None:
            # Terminal for any reason: this deadline no longer needs the
            # per-step sweep (clamped against a double finish).
            self._deadline_count = max(0, self._deadline_count - 1)
        if self._spec is not None:
            # Terminal for any reason (finish, abort, dead-letter): the
            # proposer's per-request resources (draft KV blocks) go with
            # the request's own KV blocks.
            self._spec.release(req_id)
        self._on_token.pop(req_id, None)
        rt = self._req_traces.pop(req_id, None)
        if rt is not None:
            now = time.time()
            rt.on_finish(now, seq)
            self._h_e2e.observe(now - rt.submit_s, tags=self._metric_tags)
            n = len(seq.generated)
            completed = seq.finish_reason in (FINISH_EOS, FINISH_LENGTH)
            if completed and rt.first_token_s is not None and n >= 2:
                # Mean inter-token latency after the first token (TPOT), of
                # a request that completed: an aborted, dead-lettered or
                # expired one's interval runs past its last token, and
                # loadgen's TPOT leaves such requests out (ROADMAP §D11).
                self._h_tpot.observe(
                    (now - rt.first_token_s) / (n - 1), tags=self._metric_tags
                )
        cb = self._on_finish.pop(req_id, None)
        if cb is not None:
            cb(seq)

    # ---------------- convenience ----------------

    def generate(
        self,
        prompts: List[List[int]],
        max_new_tokens: Optional[int] = None,
        eos_id: Optional[int] = None,
    ) -> List[List[int]]:
        """Run a batch of prompts to completion with continuous batching and
        return their generated token ids, in request order."""
        outputs: List[List[int]] = []
        for prompt in prompts:
            tokens: List[int] = []
            self.add_request(
                prompt,
                max_new_tokens=max_new_tokens,
                eos_id=eos_id,
                on_token=tokens.append,
            )
            outputs.append(tokens)
        while self.has_work():
            self.step()
        return outputs

    def stats(self) -> dict:
        elapsed = max(time.monotonic() - self._start, 1e-9)
        pool_bytes = self.runner.kv_pool_bytes()
        fabric_store = None
        if self._fabric is not None:
            # One store RPC per stats scrape (never per step): the store
            # is shared, so occupancy only has one true source.
            fabric_store = self._fabric.stats()
            if fabric_store:
                self._fabric_bytes_used.set(
                    float(fabric_store.get("bytes_used", 0)),
                    tags=self._metric_tags,
                )
        return {
            "engine_id": self._metric_tags["engine"],
            "device": str(self.runner.device),
            "attn_impl": self._attn_impl,
            "kv_cache_dtype": self.runner.kv_cache_dtype_str,
            "tensor_parallel_size": self._tp,
            "kv_pool_bytes": pool_bytes["aggregate"],
            "kv_pool_bytes_per_shard": pool_bytes["per_shard"],
            # The live pools' layout (None at tp=1): head-split after
            # whatever traffic ran.
            "kv_pool_sharding": self.runner.pool_sharding_spec(),
            # Weight count for the MFU estimate (decode FLOPs ~= 2 *
            # model_params per generated token).
            "model_params": self.runner.num_params,
            "host_transfer_bytes": self._host_transfer_bytes(),
            "steps": self._steps,
            "decode_tokens": self._decode_tokens,
            # Async step loop (EngineConfig.async_scheduling) + the
            # host-gap apparatus it is measured by: mean/last host time
            # between consecutive device dispatches (0 for a chained
            # async dispatch — it beat the previous step's fetch), and
            # how many records are dispatched-but-uncommitted right now.
            "async_scheduling": self._async,
            "inflight_steps": len(self._inflight),
            "host_gap_samples": self._host_gap_count,
            "host_gap_total_s": self._host_gap_total,
            "host_gap_mean_s": (
                self._host_gap_total / self._host_gap_count
                if self._host_gap_count
                else None
            ),
            "host_gap_last_s": self._host_gap_last,
            "mean_occupancy": (
                self._decode_tokens / self._decode_slot_steps
                if self._decode_slot_steps
                else 0.0
            ),
            "preemptions": self.scheduler.num_preemptions,
            "num_preemptions": self.scheduler.num_preemptions,
            "cache_utilization": self.allocator.utilization(),
            "queue_depth": len(self.scheduler.waiting),
            "num_running": len(self.scheduler.running),
            "prefill_tokens": self._prefill_tokens,
            "prefill_token_budget": self._prefill_budget,
            "prefill_backlog_tokens": (
                self.scheduler.prefill_backlog_tokens()
            ),
            "prefill_chunk_dispatches": self._prefill_chunk_dispatches,
            "chunked_prefill_requests": self._chunked_prefill_requests,
            "prefix_cache_hit_tokens": self._cache_hit_tokens,
            "prefix_cache_hit_rate": (
                self._cache_hit_tokens / max(self._prefill_tokens, 1)
            ),
            "evictable_blocks": self.allocator.num_evictable,
            "prefix_cache_evictions": self.allocator.num_evictions,
            "cow_blocks": self.scheduler.num_cow_blocks,
            "kv_pool_allocated": self.allocator.num_allocated,
            "engine_role": self.engine_config.engine_role,
            "kv_fabric": (
                self.engine_config.kv_fabric.name
                if self.engine_config.kv_fabric is not None
                else "off"
            ),
            "fabric_spill_blocks": self._fabric_spilled_total,
            "fabric_restore_blocks": self._fabric_restored_total,
            "fabric_hit_blocks": self._fabric_hit_total,
            "fabric_restored_tokens": self._fabric_restored_tokens,
            "fabric_hit_rate": (
                self._fabric_restored_tokens / max(self._prefill_tokens, 1)
            ),
            "fabric_store": fabric_store,
            "fabric_timeouts": self._fabric_timeout_total,
            "num_dead_letters": len(self._dead_letters),
            # Overload control plane: bounded-admission rejections and
            # deadline expiries.
            "shed_requests": self._shed_total,
            "expired_requests": self._expired_total,
            "max_queue_len": self.engine_config.max_queue_len,
            "max_queue_tokens": self.engine_config.max_queue_tokens,
            "speculation": (
                self._spec.name if self._spec is not None else "off"
            ),
            "spec_proposed_tokens": self._spec_proposed_total,
            "spec_accepted_tokens": self._spec_accepted_total,
            "spec_acceptance_rate": (
                self._spec_accepted_total
                / max(self._spec_proposed_total, 1)
            ),
            "spec_verify_steps": self._verify_steps,
            # Draft-mirror pool occupancy (0 without a stateful proposer):
            # must return to 0 when no requests are in flight.
            "spec_draft_pool_allocated": (
                self._spec.allocator.num_allocated
                if getattr(self._spec, "allocator", None) is not None
                else 0
            ),
            # > 1.0 means verification is amortizing decode steps: tokens
            # emitted per verify-program dispatch, correction included.
            "spec_tokens_per_verify_step": (
                self._spec_emitted_total / max(self._verify_steps, 1)
            ),
            "uptime_s": elapsed,
        }


class _HandoffLock:
    """The server's lock, handed to its longest waiter on release.

    The engine loop holds the lock for a whole step and takes it again at
    once for the next one. A plain `threading.Lock` makes no hand-off, so
    the loop nearly always wins that race and a submission, an abort or a
    `metrics()` call from another thread can wait out many steps (the
    reference package's fault: a metrics poll starved until every stream
    had finished, ROADMAP §D7). Here a release with threads queued passes
    the lock to the oldest of them, so each waits at most for the step in
    progress. It has what `threading.Condition` needs of a lock."""

    def __init__(self):
        self._mutex = threading.Lock()
        self._held = False
        self._waiters: Deque[threading.Lock] = deque()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        with self._mutex:
            if not self._held:
                self._held = True
                return True
            if not blocking:
                return False
            gate = threading.Lock()
            gate.acquire()
            self._waiters.append(gate)
        if gate.acquire(timeout=timeout):
            return True  # released by release(): the lock is ours
        with self._mutex:
            if gate in self._waiters:
                self._waiters.remove(gate)
                return False
        return True  # handed over while the wait timed out

    def release(self) -> None:
        with self._mutex:
            if not self._held:
                raise RuntimeError("release unlocked lock")
            if self._waiters:
                self._waiters.popleft().release()  # still held: handed over
            else:
                self._held = False

    def __enter__(self) -> "_HandoffLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class _RequestState:
    __slots__ = ("tokens", "done", "seq", "error")

    def __init__(self):
        self.tokens: "queue.Queue" = queue.Queue()
        self.done = threading.Event()
        self.seq: Optional[Sequence] = None
        self.error: Optional[BaseException] = None


_STREAM_END = object()


class LLMServer:
    """In-process engine server: background step loop + blocking /
    streaming generate. Concurrent generate calls from several threads are
    continuous-batched inside the one engine. ``device`` defaults to CUDA
    and raises without it; ``draft_params`` are the draft model's weights
    under ``speculation="draft"`` (see LLMEngine)."""

    def __init__(
        self,
        model_config: Optional[GPTConfig] = None,
        engine_config: Optional[EngineConfig] = None,
        params=None,
        seed: int = 0,
        warmup: bool = True,
        device=None,
        draft_params=None,
    ):
        self._engine = LLMEngine(
            model_config, engine_config, params=params, seed=seed,
            device=device, draft_params=draft_params,
        )
        try:
            self._start(warmup)
        except BaseException:
            self._engine.shutdown()
            raise

    def _start(self, warmup: bool) -> None:
        if warmup:
            # Touch every prefill bucket and the decode program now, before
            # any request: on the card this builds and loads the kernels
            # and runs every launch shape once. Warmup generations are NOT
            # real requests: per-request instrumentation is suppressed so
            # they never land in the TTFT/e2e SLO histograms (the flight
            # recorder's compile events carry warmup cost instead).
            # Speculation is suppressed too: the generate-based rounds must
            # deterministically run every prefill/decode bucket (an
            # all-zeros prompt is maximally repetitive, so the n-gram
            # proposer would reroute them through verify); the verify
            # buckets get their own pass below. Async stepping is
            # suppressed as well: the rounds run each bucket in a
            # deterministic order and step count, and the async loop's
            # decode dispatches the same program with the same launch
            # shapes, so it needs no warmup pass of its own. The KV fabric
            # is suppressed, hooks and all: the zero-prompt rounds must
            # run the FULL prefill per bucket, but a fabric warmed by an
            # earlier replica's warmup would serve them as restores
            # (partial prefill), skipping the full-prefill launch shapes,
            # and the publish/spill side would flood the shared store
            # with zero blocks at every replica start.
            instrumented = self._engine._instrument
            spec = self._engine._spec
            async_loop = self._engine._async
            publish = self._engine._publish_on_fill
            on_evict = self._engine.allocator.on_evict
            probe = self._engine.scheduler.fabric_probe
            self._engine._instrument = False
            # ray-tpu: lint-ignore[RTL403] deliberate temporary clear —
            # the finally below restores _spec on every path, so no
            # exception can skip the consumer of the saved value
            self._engine._spec = None
            self._engine._async = False
            self._engine._publish_on_fill = False
            self._engine.allocator.on_evict = None
            self._engine.scheduler.fabric_probe = None
            try:
                self._warmup()
            finally:
                self._engine._instrument = instrumented
                self._engine._spec = spec
                self._engine._async = async_loop
                self._engine._publish_on_fill = publish
                self._engine.allocator.on_evict = on_evict
                self._engine.scheduler.fabric_probe = probe
            if spec is not None:
                self._warmup_verify(spec)
        # A hand-off lock, not threading.Lock (ROADMAP §D7): see _HandoffLock.
        self._lock = _HandoffLock()
        self._work = threading.Condition(self._lock)
        self._requests: Dict[str, _RequestState] = {}
        self._shutdown = False
        self._wedged = False
        self._consecutive_step_failures = 0
        self._thread = threading.Thread(
            target=self._loop, name="llm-engine-loop", daemon=True
        )
        self._thread.start()

    @property
    def engine(self) -> LLMEngine:
        return self._engine

    def _warmup(self) -> None:
        # A bucket whose warmup request admission would refuse (e.g. the
        # block pool is smaller than the bucket) is skipped: requests that
        # large are refused at admission anyway. Any other error — a kernel
        # wrapper refusing its inputs included — stops the warmup loudly.
        ecfg = self._engine.engine_config

        def admissible(n: int, budget: int) -> bool:
            return self._engine.admission_refusal(n, budget) is None

        buckets = ecfg.buckets()
        # With a chunked-prefill budget, prompts never feed more than
        # bucket_for(budget) tokens per dispatch, so larger bucket programs
        # are unreachable. chunk_widths() is exactly the reachable set
        # (== buckets() when chunking is off).
        widths = ecfg.chunk_widths()
        for bucket in widths:
            # Prompt length landing in this bucket, shaped so the whole
            # request passes admission. 2 tokens when room allows: the
            # second forces a decode step too.
            n = bucket if bucket < buckets[-1] else bucket - 1
            n = min(n, ecfg.max_model_len - 1)
            budget = min(2, ecfg.max_model_len - n)
            if n < 1 or not admissible(n, budget):
                continue
            # Each round must exercise the FULL prefill program: drop the
            # previous round's cached zero-blocks first.
            self._engine.allocator.reset_prefix_cache()
            t0 = time.monotonic()
            self._engine.generate([[0] * n], max_new_tokens=budget)
            self._engine.flight_recorder.record_compile(
                "prefill", bucket, time.monotonic() - t0
            )
        if ecfg.enable_prefix_caching:
            # Also run every partial-prefill bucket and the copy-on-write
            # block copy. Each round seeds exactly one cached block of
            # zeros, then prefills a zero-prompt whose uncached suffix
            # lands in the target bucket; the duplicate-prompt round at the
            # end exercises the fully-cached path (CoW + smallest suffix
            # bucket).
            alloc = self._engine.allocator
            bs = ecfg.block_size
            for bucket in widths + (0,):
                alloc.reset_prefix_cache()
                n = min(bs + bucket, ecfg.max_model_len - 1, buckets[-1])
                if not (admissible(bs, 1) and admissible(n, 1)):
                    continue
                t0 = time.monotonic()
                self._engine.generate([[0] * bs], max_new_tokens=1)
                if n > bs:
                    self._engine.generate([[0] * n], max_new_tokens=1)
                else:  # CoW round: repeat the fully-cached prompt
                    self._engine.generate([[0] * bs], max_new_tokens=1)
                self._engine.flight_recorder.record_compile(
                    "cow" if n <= bs else "partial_prefill",
                    0 if n <= bs else bucket,
                    time.monotonic() - t0,
                )
            alloc.reset_prefix_cache()
        if ecfg.prefill_token_budget is not None:
            # Chunked prefill dispatches BOTH prefill program families at
            # every reachable width: run each (width x program) pair
            # directly against the null block — writes land in block 0 and
            # no allocator state is touched.
            runner = self._engine.runner
            null_table = [0] * ecfg.max_blocks_per_seq
            for w in widths:
                t0 = time.monotonic()
                runner.prefill([0] * w, [0])
                runner.prefill_suffix([0] * w, null_table, 0)
                self._engine.flight_recorder.record_compile(
                    "chunk_prefill", w, time.monotonic() - t0
                )

    def _warmup_verify(self, spec) -> None:
        """Run every k-token verify bucket plus whatever the proposer owns
        (the draft model's prefill/decode programs), so the first
        speculative step under live traffic never meets a cold launch
        shape. The synthetic verify calls run against all-null block
        tables: writes land in the null block (the masked-lane convention)
        and touch no allocator state."""
        ecfg = self._engine.engine_config
        runner = self._engine.runner
        slots = ecfg.max_decode_slots
        nb = ecfg.max_blocks_per_seq
        for s_bucket in ecfg.verify_buckets():
            t0 = time.monotonic()
            runner.verify(
                np.zeros((slots, s_bucket), np.int32),
                np.zeros((slots, nb), np.int32),
                np.zeros((slots,), np.int32),
                np.full((slots,), s_bucket, np.int32),
            )
            self._engine.flight_recorder.record_compile(
                "verify", s_bucket, time.monotonic() - t0
            )
        t0 = time.monotonic()
        spec.warmup()
        self._engine.flight_recorder.record_compile(
            f"proposer:{spec.name}", 0, time.monotonic() - t0
        )

    # ---------------- engine loop ----------------

    def _loop(self) -> None:
        max_failures = self._engine.engine_config.max_consecutive_step_failures
        while True:
            with self._work:
                while not self._shutdown and not self._engine.has_work():
                    self._work.wait()
                if self._shutdown:
                    return
            # Step outside the condition wait but under the lock: the engine
            # is single-threaded and submissions mutate scheduler state.
            with self._lock:
                try:
                    self._engine.step()
                    self._consecutive_step_failures = 0
                    continue
                except BaseException as exc:
                    self._consecutive_step_failures += 1
                    # Attribution comes FIRST: an isolatable poison request
                    # is dead-lettered even at the failure threshold.
                    culprit = self._engine.culprit_for(exc)
                    recorder = self._engine.flight_recorder
                    # Under async_scheduling a commit-time failure is
                    # attributed one step late: failure_step() resolves
                    # to the in-flight record's DISPATCH index (sync
                    # mode: the current step, as before).
                    step_idx = self._engine.failure_step()
                    if culprit is not None:
                        # Poison-request isolation: fail only the culpable
                        # request (dead-letter + KV release) and keep
                        # stepping for everyone else. The waiter's error is
                        # set BEFORE fail_request fires its finish callback
                        # so the caller never sees a clean finish.
                        state = self._requests.get(culprit)
                        if state is not None and not state.done.is_set():
                            state.error = PoisonRequestError(
                                request_id=culprit, cause=exc
                            )
                        if self._engine.fail_request(culprit, exc):
                            # Contained: only steps that fail WITHOUT an
                            # isolatable culprit count toward wedging.
                            self._consecutive_step_failures = 0
                        recorder.record_failure(
                            step_idx, repr(exc), request_id=culprit,
                            action="dead_letter",
                        )
                        continue
                    if (
                        self._consecutive_step_failures < max_failures
                        and not isinstance(exc, TensorParallelError)
                    ):
                        recorder.record_failure(
                            step_idx, repr(exc), action="retry"
                        )
                        # Unattributable failure (e.g. the batched decode
                        # program itself): per-sequence state only mutates
                        # after the risky calls return, so retrying the
                        # step is safe.
                        continue
                    # Wedged: broadcast to every waiter while still holding
                    # the lock so no submission can slip in between the
                    # error broadcast and the thread actually dying.
                    recorder.record_failure(
                        step_idx, repr(exc), action="wedged"
                    )
                    self._wedged = True
                    self._shutdown = True
                    self._engine.close_traces(exc)
                    for state in self._requests.values():
                        if not state.done.is_set():
                            state.error = exc
                            state.tokens.put(_STREAM_END)
                            state.done.set()
                    import traceback

                    traceback.print_exc()
                    return

    def _submit(
        self,
        prompt_ids: List[int],
        max_new_tokens: Optional[int],
        eos_id: Optional[int],
        request_id: Optional[str],
        deadline_s: Optional[float] = None,
    ) -> tuple[str, _RequestState]:
        state = _RequestState()

        def on_finish(seq: Sequence) -> None:
            state.seq = seq
            state.tokens.put(_STREAM_END)
            state.done.set()

        with self._work:
            if self._shutdown or not self._thread.is_alive():
                raise RuntimeError(
                    "LLM engine loop is not running (shut down or crashed); "
                    "restart the server"
                )
            if request_id is not None and request_id in self._requests:
                raise ValueError(
                    f"request_id {request_id!r} already has an in-flight "
                    "generation on this server"
                )
            # Bounded admission fails fast HERE: add_request raises a
            # typed, retryable EngineOverloadedError before any state
            # lands in _requests.
            rid = self._engine.add_request(
                prompt_ids,
                max_new_tokens=max_new_tokens,
                eos_id=eos_id,
                request_id=request_id,
                on_token=state.tokens.put,
                on_finish=on_finish,
                deadline_s=deadline_s,
            )
            self._requests[rid] = state
            self._work.notify_all()
        return rid, state

    # ---------------- public API ----------------

    def generate(
        self,
        prompt_ids: List[int],
        max_new_tokens: Optional[int] = None,
        eos_id: Optional[int] = None,
        request_id: Optional[str] = None,
        timeout_s: float = 120.0,
    ) -> dict:
        """Blocking generation. `timeout_s` is the request's END-TO-END
        deadline: it bounds this call's wait AND rides into the engine as
        an absolute monotonic deadline, so a request that cannot finish in
        time is dropped from the queue before its prefill ever runs (or
        aborted mid-decode with its blocks reclaimed). Either side
        tripping first raises TimeoutError."""
        deadline = (
            time.monotonic() + timeout_s if timeout_s is not None else None
        )
        rid, state = self._submit(
            prompt_ids, max_new_tokens, eos_id, request_id, deadline
        )
        try:
            if not state.done.wait(timeout=timeout_s):
                # The request may have finished in the instant between the
                # wait expiring and the abort landing; only a successful
                # abort is a real timeout.
                if self.abort(rid) or not state.done.is_set():
                    raise TimeoutError(
                        f"generation {rid} timed out after {timeout_s}s"
                    )
            if state.error is not None:
                raise state.error
            if (
                state.seq is not None
                and state.seq.finish_reason == FINISH_EXPIRED
            ):
                raise TimeoutError(
                    f"generation {rid} exceeded its {timeout_s}s deadline"
                )
            token_ids = []
            while True:
                item = state.tokens.get_nowait()
                if item is _STREAM_END:
                    break
                token_ids.append(item)
            return {
                "request_id": rid,
                "token_ids": token_ids,
                "finish_reason": state.seq.finish_reason if state.seq else None,
                "num_preemptions": state.seq.num_preemptions if state.seq else 0,
            }
        finally:
            with self._lock:
                self._requests.pop(rid, None)

    def generate_stream(
        self,
        prompt_ids: List[int],
        max_new_tokens: Optional[int] = None,
        eos_id: Optional[int] = None,
        request_id: Optional[str] = None,
        timeout_s: float = 120.0,
        stream_idle_timeout_s: Optional[float] = None,
    ):
        """Yields token ids as the engine produces them.

        `timeout_s` is the END-TO-END deadline, as on the blocking path;
        an expiring stream is aborted with its blocks reclaimed and this
        generator raises TimeoutError after yielding whatever was already
        emitted. `stream_idle_timeout_s` (optional) additionally bounds
        the gap between consecutive tokens."""
        deadline = (
            time.monotonic() + timeout_s if timeout_s is not None else None
        )
        rid, state = self._submit(
            prompt_ids, max_new_tokens, eos_id, request_id, deadline
        )
        try:
            while True:
                wait = stream_idle_timeout_s
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    wait = remaining if wait is None else min(wait, remaining)
                if wait is not None and wait < 0.0:
                    wait = 0.0  # Queue.get rejects negative timeouts
                try:
                    item = state.tokens.get(timeout=wait)
                except queue.Empty:
                    self.abort(rid)
                    if deadline is not None and time.monotonic() >= deadline:
                        raise TimeoutError(
                            f"generation {rid} exceeded its {timeout_s}s "
                            "deadline"
                        ) from None
                    raise TimeoutError(
                        f"generation {rid} produced no token for "
                        f"{stream_idle_timeout_s}s"
                    ) from None
                if item is _STREAM_END:
                    break
                yield item
            if state.error is not None:
                raise state.error
            if (
                state.seq is not None
                and state.seq.finish_reason == FINISH_EXPIRED
            ):
                raise TimeoutError(
                    f"generation {rid} exceeded its {timeout_s}s deadline"
                )
        finally:
            # Closed before exhaustion (consumer gone): abort so the pool
            # returns to steady state now. A finished request is no longer
            # active, so the abort is a no-op on the normal path.
            with self._lock:
                self._requests.pop(rid, None)
                self._engine.abort(rid)

    def abort(self, request_id: str) -> bool:
        with self._lock:
            return self._engine.abort(request_id)

    def metrics(self) -> dict:
        with self._lock:
            stats = self._engine.stats()
            stats["wedged"] = self._wedged
            stats["consecutive_step_failures"] = self._consecutive_step_failures
            return stats

    def autoscaling_snapshot(self) -> dict:
        """Compact SLO signal bundle for the serve controller's
        LLMAutoscalingPolicy: the engine's queue-time and TTFT histogram
        series (snapshotted engine-side so the numbers are correct even
        when the engine actor runs out-of-process from the controller)
        plus the prefill backlog and load counts. The controller diffs
        two snapshots to get a look-back window — scale-up triggers on
        RECENT p99, not the engine's lifetime percentile."""
        with self._lock:
            e = self._engine
            return {
                "engine_id": e._metric_tags["engine"],
                "queue_depth": len(e.scheduler.waiting),
                "num_running": len(e.scheduler.running),
                # Decode occupancy bound: num_running at max_decode_slots
                # means the engine is decode-SATURATED even when the
                # admission-time histograms are silent (long generations,
                # no new arrivals) — the policy must not read that
                # silence as idleness and scale the fleet down.
                "max_decode_slots": e.engine_config.max_decode_slots,
                "prefill_backlog_tokens": int(
                    e.scheduler.prefill_backlog_tokens()
                ),
                "queue_time": e._h_queue.snapshot(e._metric_tags),
                "ttft": e._h_ttft.snapshot(e._metric_tags),
            }

    def stats(self) -> dict:
        """Alias of metrics(): the engine's counters plus the loop's
        health fields."""
        return self.metrics()

    def dead_letters(self) -> List[dict]:
        """Records of requests failed in isolation after poisoning an
        engine step (id, prompt hash, error, step), oldest first."""
        with self._lock:
            return self._engine.dead_letters()

    def shed_requests(self) -> List[dict]:
        """Records of submissions rejected by bounded admission or dead
        on arrival, oldest first."""
        with self._lock:
            return self._engine.shed_requests()

    def flight_record(self, steps_limit: Optional[int] = None) -> dict:
        """The engine flight recorder: bounded rings of per-step records,
        warmup events, and step failures with the action taken."""
        with self._lock:
            return self._engine.flight_recorder.snapshot(steps_limit)

    def observability_snapshot(
        self, steps_limit: Optional[int] = None
    ) -> dict:
        """metrics + dead letters + flight recorder in ONE actor round trip
        (the dashboard /api/llm panel polls this; three separate RPCs per
        engine per refresh would triple the scrape's exposure to a busy
        engine's lock)."""
        with self._lock:
            e = self._engine
            stats = e.stats()
            stats["wedged"] = self._wedged
            stats["consecutive_step_failures"] = self._consecutive_step_failures
            return {
                "metrics": stats,
                "dead_letters": e.dead_letters(),
                "shed_requests": e.shed_requests(),
                "flight_record": e.flight_recorder.snapshot(steps_limit),
                # Engine-side histogram snapshots for cross-replica
                # aggregation (the fleet collector, ROADMAP §B12):
                # snapshotted here so the numbers are correct even when
                # the engine actor runs out-of-process from the collector.
                "histograms": {
                    "llm_request_ttft_seconds": e._h_ttft.snapshot(
                        e._metric_tags
                    ),
                    "llm_request_time_per_output_token_seconds": (
                        e._h_tpot.snapshot(e._metric_tags)
                    ),
                    "llm_request_queue_time_seconds": e._h_queue.snapshot(
                        e._metric_tags
                    ),
                    "llm_request_e2e_seconds": e._h_e2e.snapshot(
                        e._metric_tags
                    ),
                    "llm_engine_step_host_gap_seconds": (
                        e._h_host_gap.snapshot(e._metric_tags)
                    ),
                },
            }

    def reset_prefix_cache(self) -> None:
        """Drop all cached-but-unreferenced KV blocks (e.g. after swapping
        the served weights, whose cached activations would be stale)."""
        with self._lock:
            self._engine.allocator.reset_prefix_cache()

    def flush_kv_fabric(self) -> int:
        """Demote the engine's cached-but-unreferenced KV blocks into the
        fabric (the drain path's cache preservation — called by the
        ingress replica's shutdown before the engine stops); returns
        blocks resident in the fabric afterwards, 0 without a fabric."""
        with self._lock:
            return self._engine.flush_kv_fabric()

    def num_pending(self) -> int:
        with self._lock:
            return len(self._engine.scheduler.waiting) + len(
                self._engine.scheduler.running
            )

    def check_health(self) -> bool:
        # ray-tpu: lint-ignore[RTL201] atomic bool read; taking the engine
        # lock here would park the health probe behind a full step (or a
        # bucket compile) and make the controller churn healthy replicas
        return self._thread.is_alive() and not self._wedged

    def shutdown(self) -> None:
        # Preserve the prefix cache past the server's end: flush the
        # evictable keyed blocks into the fabric (no-op without one)
        # before the step loop stops. Best effort — shutdown proceeds
        # regardless.
        try:
            self.flush_kv_fabric()
        except Exception:
            pass
        with self._work:
            self._shutdown = True
            # Fail in-flight requests promptly instead of leaving their
            # callers to run out their full wait timeout.
            exc = RuntimeError("LLM engine shut down with requests in flight")
            if self._requests:
                self._engine.close_traces(exc)
            for state in self._requests.values():
                if not state.done.is_set():
                    state.error = exc
                    state.tokens.put(_STREAM_END)
                    state.done.set()
            self._work.notify_all()
        self._thread.join(timeout=10.0)
        # Stops a tensor-parallel engine's ranks; under the lock, so no
        # step is running on them.
        with self._lock:
            self._engine.shutdown()
