"""Serve integration: proxy → replica → engine actor → paged cache.

The ingress deployment is thin — replicas forward requests to one shared,
named `LLMServer` engine actor, so scaling HTTP replicas does not duplicate
model weights or split the continuous batch. Streaming responses ride the
actor streaming-generator path into Serve's ndjson/`stream=True` plumbing.

The engine runs on the card: `build_app`, `LLMIngress` and
`get_or_create_engine_actor` take `device=` (default "cuda"), raise without
CUDA unless the caller passes `device="cpu"`, and hand it to
`LLMServer(device=...)`. Weights go in as host arrays (numpy, as
`params_from_flax` gives them, or CPU tensors): the engine's runner moves
them onto the device once. With a `kv_fabric`, a deployment may declare
prefix-affinity routing, and a replica that owns its engine flushes it into
the fabric before stopping it.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Optional

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.llm.config import EngineConfig
from ray_tpu_torch.llm.engine import LLMServer
from ray_tpu_torch.models.gpt import GPTConfig


def _serve_device(device) -> str:
    """The device rule of the port's entry points, as a string that
    crosses actor boundaries: None means CUDA, which raises without it."""
    return str(resolve_device(device))


# Threads of the engine actor beyond its live streams: sheds, blocking
# requests and control calls (metrics, aborts, snapshots). The reference's
# whole pool is this size.
ENGINE_SPARE_THREADS = 32


def engine_concurrency(engine_config: Optional[EngineConfig]) -> int:
    """The engine actor's thread pool. Every live stream holds one of its
    threads for the stream's whole life, so a pool no larger than what
    bounded admission lets live (max_decode_slots running plus
    max_queue_len queued) leaves a request that should be shed at once
    waiting for a stream to end, and metrics and aborts with it. The
    reference's fixed 32 is exactly that on the card's engine (16 + 16);
    the port keeps ENGINE_SPARE_THREADS beyond the live streams (ROADMAP
    §D9)."""
    ecfg = engine_config or EngineConfig()
    return ecfg.max_decode_slots + (ecfg.max_queue_len or 0) + ENGINE_SPARE_THREADS


def get_or_create_engine_actor(
    engine_name: str = "default",
    model_config: Optional[GPTConfig] = None,
    engine_config: Optional[EngineConfig] = None,
    params=None,
    seed: int = 0,
    max_concurrency: Optional[int] = None,
    draft_params=None,
    device=None,
):
    """Named engine actor shared by every ingress replica. With
    `engine_config.speculation="draft"`, `draft_params` carries the draft
    model's trained weights (seed-initialized otherwise). `device`
    defaults to CUDA and raises without it; pass "cpu" to serve there.
    `max_concurrency` defaults to `engine_concurrency(engine_config)`."""
    device = _serve_device(device)
    if max_concurrency is None:
        max_concurrency = engine_concurrency(engine_config)
    return (
        ray_tpu_torch.remote(LLMServer)
        .options(
            name=f"llm_engine:{engine_name}",
            get_if_exists=True,
            max_concurrency=max_concurrency,
        )
        .remote(
            model_config, engine_config, params, seed,
            draft_params=draft_params, device=device,
        )
    )


def llm_stream_resume(args: tuple, kwargs: dict, items: list):
    """Failover resume policy for LLMIngress token streams (pass as
    `handle.options(stream=True, stream_resume_fn=llm_stream_resume)`).

    When a replica dies mid-stream, the router re-submits the request with
    the token ids the client has already received folded into the prompt,
    so the resumed stream continues exactly where the dead replica stopped
    and the client-visible stream stays contiguous. With prefix caching the
    resumed prefill is mostly cache hits, so a mid-stream failover costs
    roughly one tail-block prefill. Greedy decoding makes the resumed
    continuation token-identical (the same mechanism as recompute-style
    preemption). Returns None when the stream was already complete.

    Note: resuming computes the remaining budget from the request's own
    "max_new_tokens"; requests that rely on the engine-side default should
    set it explicitly to keep failover from restarting the budget."""
    request = dict(args[0])
    generated = [item["token_id"] for item in items]
    max_new = request.get("max_new_tokens")
    eos_id = request.get("eos_id")
    if eos_id is not None and generated and generated[-1] == eos_id:
        return None
    if max_new is not None and len(generated) >= int(max_new):
        return None
    request["prompt_ids"] = list(request["prompt_ids"]) + generated
    if max_new is not None:
        request["max_new_tokens"] = int(max_new) - len(generated)
    # The resumed tail is a fresh engine request: a pinned request_id could
    # collide with the orphaned original still draining on the engine.
    request.pop("request_id", None)
    return (request,) + tuple(args[1:]), kwargs


class LLMIngress:
    """Deployment callable: JSON dict in, generated token ids (or a token
    stream) out.

    Request schema: {"prompt_ids": [int, ...], "max_new_tokens": int?,
    "eos_id": int?, "stream": bool?, "request_id": str?, "timeout_s":
    float?, "stream_idle_timeout_s": float?} — timeout_s is the request's
    END-TO-END deadline on BOTH paths: the engine derives an absolute
    monotonic deadline at submission and enforces it through admission,
    queueing, and decode, so an expired request is dropped with its KV
    (and draft-mirror) blocks reclaimed rather than decoding for a client
    that stopped waiting. stream_idle_timeout_s additionally bounds the
    PER-TOKEN gap on streams — the job timeout_s itself did before the
    overload control plane landed; clients that relied on the old
    per-token meaning should pass stream_idle_timeout_s instead (the old
    field is still accepted, it just means the end-to-end budget now).
    """

    # Minimum gap between engine autoscaling_snapshot RPCs: the controller
    # polls replica metrics every reconcile pass (~50ms) and N replicas
    # share one engine — without the cache the engine's lock would see
    # 20/s x replicas control-plane acquisitions.
    AUTOSCALING_METRICS_TTL_S = 0.25
    # Last-good fallback age cap: past this, a degraded engine's frozen
    # snapshot stops being replayed to the controller as fresh — the
    # autoscaler sees a signal GAP (holds current count) instead of
    # stale absolute values that could pin scale decisions indefinitely.
    AUTOSCALING_METRICS_STALE_S = 5.0

    def __init__(
        self,
        engine_name: str = "default",
        model_config: Optional[GPTConfig] = None,
        engine_config: Optional[EngineConfig] = None,
        params=None,
        seed: int = 0,
        draft_params=None,
        engine_per_replica: bool = False,
        device=None,
    ):
        device = _serve_device(device)
        # engine_per_replica gives THIS replica its own engine actor
        # (unique name suffix — each replica's __init__ runs in its own
        # replica actor) instead of the one shared named engine. That
        # trades weight duplication for replica-local KV caches, which is
        # the configuration where the KV fabric earns its keep: replicas
        # share prefixes through the fabric's host tier + prefix-affinity
        # routing rather than through one engine's device cache.
        self._owns_engine = bool(engine_per_replica)
        if self._owns_engine:
            engine_name = f"{engine_name}-{uuid.uuid4().hex[:8]}"
        self._engine = get_or_create_engine_actor(
            engine_name, model_config, engine_config, params=params,
            seed=seed, draft_params=draft_params, device=device,
        )
        self._as_snapshot: Optional[dict] = None
        self._as_snapshot_t = 0.0

    def __call__(self, request: dict):
        if not isinstance(request, dict) or "prompt_ids" not in request:
            raise ValueError(
                'LLM requests must be {"prompt_ids": [...], ...}, got '
                f"{type(request).__name__}"
            )
        prompt_ids = request["prompt_ids"]
        max_new_tokens = request.get("max_new_tokens")
        eos_id = request.get("eos_id")
        request_id = request.get("request_id")
        timeout_s = request.get("timeout_s")
        idle_timeout_s = request.get("stream_idle_timeout_s")
        kwargs = {} if timeout_s is None else {"timeout_s": float(timeout_s)}
        if request.get("stream"):
            if idle_timeout_s is not None:
                kwargs["stream_idle_timeout_s"] = float(idle_timeout_s)
            # A mid-stream client disconnect must be able to abort the
            # engine request (below), and abort is keyed by request_id —
            # pin one now when the client didn't.
            if request_id is None:
                request_id = uuid.uuid4().hex
            engine = self._engine

            def token_stream():
                # Client disconnect propagation: when the proxy/consumer
                # closes this generator before exhaustion (GeneratorExit on
                # stream cancel, or plain GC of an abandoned stream), the
                # engine request is still decoding into its KV blocks — and
                # with speculation=draft, into the draft-mirror blocks too.
                # Abort it so those blocks free immediately instead of the
                # engine generating max_new_tokens for nobody. The engine
                # dispatch happens INSIDE the body: a never-started
                # generator's finally would never run, so submitting here
                # keeps "no consumer ever pulled" from leaking a request
                # the abort could not cover.
                refs = engine.generate_stream.options(
                    num_returns="streaming"
                ).remote(
                    prompt_ids, max_new_tokens, eos_id, request_id, **kwargs
                )
                completed = False
                try:
                    for ref in refs:
                        yield {"token_id": ray_tpu_torch.get(ref)}
                    completed = True
                finally:
                    if not completed:
                        # Fire-and-forget: the abort's outcome is not
                        # actionable here (a finished request no-ops), and
                        # blocking the closing stream thread on a busy
                        # engine's lock would serialize mass-disconnect
                        # cleanup exactly under queueing collapse.
                        try:
                            _ = engine.abort.remote(request_id)
                        except Exception:
                            pass  # engine gone: its pool died with it

            return token_stream()
        return ray_tpu_torch.get(
            self._engine.generate.remote(
                prompt_ids, max_new_tokens, eos_id, request_id, **kwargs
            )
        )

    def metrics(self) -> dict:
        return ray_tpu_torch.get(self._engine.metrics.remote())

    def autoscaling_metrics(self) -> dict:
        """SLO signals for the controller's LLMAutoscalingPolicy, riding
        the replica metrics poll (ReplicaActor.get_metrics calls this):
        the engine's queue-time/TTFT histogram snapshots and prefill
        backlog (LLMServer.autoscaling_snapshot). TTL-cached; on an engine
        timeout the last good snapshot is returned — a busy engine is
        exactly when the autoscaler most needs a (slightly stale) signal,
        not a gap."""
        now = time.monotonic()
        if (
            self._as_snapshot is not None
            and now - self._as_snapshot_t < self.AUTOSCALING_METRICS_TTL_S
        ):
            return self._as_snapshot
        try:
            snap = ray_tpu_torch.get(
                self._engine.autoscaling_snapshot.remote(), timeout=1.0
            )
        except Exception:
            if now - self._as_snapshot_t > self.AUTOSCALING_METRICS_STALE_S:
                return {}
            return self._as_snapshot or {}
        self._as_snapshot = snap
        self._as_snapshot_t = now
        return snap

    def dead_letters(self) -> list:
        """Records of requests failed in isolation after poisoning an
        engine step (see LLMServer.dead_letters)."""
        return ray_tpu_torch.get(self._engine.dead_letters.remote())

    def flight_record(self, steps_limit: Optional[int] = None) -> dict:
        """The engine flight recorder (see LLMServer.flight_record):
        per-step records, warmup compile events, and step failures."""
        return ray_tpu_torch.get(self._engine.flight_record.remote(steps_limit))

    def observability_snapshot(
        self, steps_limit: Optional[int] = None
    ) -> dict:
        """metrics + dead letters + flight recorder in one engine round
        trip (see LLMServer.observability_snapshot) — with speculation on,
        the metrics carry the acceptance-rate story (spec_acceptance_rate,
        spec_tokens_per_verify_step) and the step records the per-step
        proposed/accepted counts."""
        return ray_tpu_torch.get(
            self._engine.observability_snapshot.remote(steps_limit)
        )

    def reset_prefix_cache(self) -> None:
        """Drop the engine's cached-but-unreferenced KV blocks (call after
        swapping served params, whose cached activations would be stale)."""
        ray_tpu_torch.get(self._engine.reset_prefix_cache.remote())

    def shutdown(self) -> None:
        """Drain-path teardown (ReplicaActor.prepare_for_shutdown calls
        this on the DRAINING→STOPPED transition, after in-flight requests
        finished): when this replica OWNS its engine, flush the engine's
        evictable keyed blocks into the KV fabric — the drained replica's
        reusable prefixes survive as fabric entries a surviving replica
        can restore, instead of dying with the engine actor — then stop
        the engine. A shared engine outlives the replica, so there is
        nothing to flush or stop. Every step is best-effort: shutdown
        must complete even with the fabric or engine already gone."""
        if not self._owns_engine:
            return
        try:
            ray_tpu_torch.get(
                self._engine.flush_kv_fabric.remote(), timeout=30.0
            )
        except Exception:
            pass
        try:
            ray_tpu_torch.get(self._engine.shutdown.remote(), timeout=10.0)
        except Exception:
            pass
        try:
            ray_tpu_torch.kill(self._engine)
        except Exception:
            pass

    def check_health(self) -> bool:
        """Replica health forwards to the engine, but a busy engine (e.g.
        compiling a new bucket) must read as healthy — the controller's probe
        window is short and killing the replica would not unblock anything.
        Only a dead/raising engine fails the probe (the replacement replica
        then re-creates the named engine actor)."""
        from ray_tpu_torch.exceptions import ActorError

        try:
            healthy = bool(
                ray_tpu_torch.get(self._engine.check_health.remote(), timeout=1.0)
            )
        except TimeoutError:
            return True
        except ActorError:
            return False
        if not healthy:
            # A wedged engine never recovers on its own, and because it is a
            # NAMED actor, merely replacing this replica would hand the
            # replacement the same wedged engine (get_if_exists). Put it
            # down so the replacement replica re-creates it fresh.
            try:
                ray_tpu_torch.kill(self._engine)
            except Exception:
                pass  # already dead / runtime tearing down
        return healthy


def build_app(
    model_config: Optional[GPTConfig] = None,
    engine_config: Optional[EngineConfig] = None,
    *,
    params=None,
    engine_name: Optional[str] = None,
    num_replicas: int = 1,
    max_concurrent_queries: int = 32,
    seed: int = 0,
    draft_params=None,
    autoscaling_config: Any = None,
    graceful_shutdown_timeout_s: Optional[float] = None,
    engine_per_replica: bool = False,
    device=None,
) -> serve.Application:
    """Bind the LLM ingress for `serve.run` (HTTP via the existing proxy:
    POST /<app> with the request JSON). Pass trained weights via `params`;
    without them the engine serves a seed-initialized model.

    Scaling `num_replicas` adds HTTP ingress replicas, never weight
    copies: every replica forwards to the one shared engine actor, whose
    warmup runs every bucket before the deployment reports healthy.
    `engine_config.tensor_parallel_size > 1` makes that one engine actor
    span tp devices: its process is rank 0, and it spawns one process per
    other rank (weights Megatron-split, KV pools head-split, see
    LLMEngine); its warmup runs every bucket on every rank.

    `autoscaling_config` accepts serve.LLMAutoscalingPolicy (SLO-driven:
    the ingress feeds the engine's queue-time/TTFT histogram windows and
    prefill backlog to the controller) or the queue-depth
    AutoscalingConfig; `graceful_shutdown_timeout_s` bounds how long a
    draining replica's in-flight streams may run before being
    stream-resumed onto surviving replicas.

    Each build_app call gets its own engine actor by default — the engine
    is keyed by `engine_name`, so two apps share one engine (one copy of
    the weights, one continuous batch) only when given the same explicit
    name. Never reuse a name across different model configs/params: the
    first creation wins and later apps would silently serve its weights.

    `device` defaults to CUDA and raises here, before anything is
    deployed, when CUDA is absent; pass "cpu" to serve on the CPU. Pass
    `params` as host arrays: the runner moves them onto the device once."""
    device = _serve_device(device)
    if engine_name is None:
        engine_name = uuid.uuid4().hex[:8]
    deployment = serve.deployment(
        LLMIngress,
        name="LLMIngress",
        num_replicas=num_replicas,
        max_concurrent_queries=max_concurrent_queries,
    )
    if autoscaling_config is not None or graceful_shutdown_timeout_s is not None:
        deployment = deployment.options(
            autoscaling_config=autoscaling_config,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
        )
    # Declare the LLM stream-resume policy ON the deployment: handles
    # built from its config (serve.run's return, get_app_handle, and the
    # HTTP proxy's streaming path) migrate interrupted token streams onto
    # surviving replicas — HTTP clients survive drains/kills too, without
    # opting in per handle.
    deployment = deployment.options(stream_resume_fn=llm_stream_resume)
    if (
        engine_config is not None
        and engine_config.kv_fabric is not None
        and engine_config.kv_fabric.affinity
    ):
        # Prefix-affinity routing rides the same declared-on-deployment
        # path as stream resume: every handle built from the app's config
        # prefers the rendezvous replica for the prompt's leading
        # block-chain hash, so multi-turn sessions land where their KV
        # cache (device tier or fabric tier) already lives. Strictly a
        # tie-break — drain/exclusion/capacity still decide first.
        from ray_tpu_torch.llm.kvfabric.affinity import LLMPrefixAffinity

        deployment = deployment.options(
            affinity_key_fn=LLMPrefixAffinity(engine_config.block_size)
        )
    return deployment.bind(
        engine_name, model_config, engine_config, params=params, seed=seed,
        draft_params=draft_params, engine_per_replica=engine_per_replica,
        device=device,
    )
