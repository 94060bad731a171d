"""Deployment + autoscaling config schemas.

Reference: serve/config.py (DeploymentConfig), serve/_private/autoscaling_policy.py
and serve/schema.py (declarative REST schema).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

# Client-side failover defaults, shared by DeploymentConfig and bare
# Router/DeploymentHandle construction (ray_tpu_torch.serve.handle) so the two
# paths can't drift.
DEFAULT_RETRY_BUDGET = 3  # re-dispatches per request after the first attempt
DEFAULT_BACKOFF_INITIAL_S = 0.05


@dataclass
class AutoscalingConfig:
    """Queue-depth driven replica autoscaling (reference:
    serve/_private/autoscaling_policy.py:9 calculate_desired_num_replicas).

    `total_ongoing` fed to `desired_replicas` is the TIME-WINDOW AVERAGE
    of the ongoing-requests metric over `look_back_period_s` (the
    controller samples every reconcile pass and averages the window), so
    one bursty sample can neither trigger a scale-up nor a scale-down —
    flap prevention comes from the window, not from extra smoothing."""

    min_replicas: int = 1
    max_replicas: int = 1
    target_num_ongoing_requests_per_replica: float = 1.0
    upscale_smoothing_factor: float = 1.0
    downscale_smoothing_factor: float = 1.0
    metrics_interval_s: float = 0.1
    look_back_period_s: float = 2.0

    def desired_replicas(self, total_ongoing: float, current: int) -> int:
        if current == 0:
            return max(self.min_replicas, 1 if total_ongoing > 0 else 0)
        per_replica = total_ongoing / current
        error_ratio = per_replica / max(
            self.target_num_ongoing_requests_per_replica, 1e-9
        )
        smoothing = (
            self.upscale_smoothing_factor
            if error_ratio > 1
            else self.downscale_smoothing_factor
        )
        desired = current * (1.0 + (error_ratio - 1.0) * smoothing)
        import math

        desired = math.ceil(desired - 1e-9)
        return max(self.min_replicas, min(self.max_replicas, desired))


@dataclass
class LLMAutoscalingPolicy:
    """SLO-driven replica autoscaling for LLM deployments.

    Scales on the ENGINE's own serving signals instead of queue depth:
    the replica's callable exposes `autoscaling_metrics()` (LLMIngress
    forwards `LLMServer.autoscaling_snapshot()` — queue-time/TTFT
    histogram snapshots plus `llm_engine_prefill_backlog_tokens`), the
    controller diffs histogram windows over `look_back_period_s`, and
    this policy decides from the windowed p99s — scaling up BEFORE the
    cumulative p99 burns, because the window sees only recent requests.

    Hysteresis: scale-up fires as soon as any configured target is
    exceeded in the window (one step per `upscale_cooldown_s`);
    scale-down requires a COMPLETE look-back window in which every
    configured signal stayed below `downscale_margin` x target and the
    prefill backlog is empty, one step per `downscale_cooldown_s` — so a
    burst's tail can't flap the fleet.

    `target_burn_rate` reads `signals["slo_burn_rate"]`, which
    `observability.SLOBurnRateMonitor.autoscaler_signal()` gives (its
    shortest window's burn), as in the reference. Without a monitor
    feeding it the signal is None: the burn target then never fires, and
    the other targets decide."""

    min_replicas: int = 1
    max_replicas: int = 2
    # At least one target must be set; each is a p99 bound in seconds over
    # the look-back window (None = signal not used).
    target_queue_time_p99_s: Optional[float] = None
    target_ttft_p99_s: Optional[float] = None
    # Scale up when backlog / current_replicas exceeds this (None = unused).
    max_prefill_backlog_per_replica: Optional[float] = None
    # SLO burn-rate ceiling (observability.SLOBurnRateMonitor feeds
    # signals["slo_burn_rate"]): hot above it — the fleet is consuming
    # error budget faster than the SLO allows (1.0 = exactly at budget).
    target_burn_rate: Optional[float] = None
    look_back_period_s: float = 2.0
    downscale_margin: float = 0.5
    upscale_cooldown_s: float = 0.5
    downscale_cooldown_s: float = 2.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError(
                "LLMAutoscalingPolicy needs min_replicas >= 1 (an LLM "
                "replica's warmup makes scale-from-zero a cold-compile "
                "under live traffic)"
            )
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if (
            self.target_queue_time_p99_s is None
            and self.target_ttft_p99_s is None
            and self.max_prefill_backlog_per_replica is None
            and self.target_burn_rate is None
        ):
            raise ValueError(
                "LLMAutoscalingPolicy needs at least one target: "
                "target_queue_time_p99_s, target_ttft_p99_s, "
                "max_prefill_backlog_per_replica, or target_burn_rate"
            )
        if self.target_burn_rate is not None and self.target_burn_rate <= 0:
            raise ValueError("target_burn_rate must be > 0")
        if not 0.0 < self.downscale_margin <= 1.0:
            raise ValueError("downscale_margin must be in (0, 1]")

    def desired_replicas(self, signals: dict, current: int) -> int:
        """Decide the target count from windowed SLO signals:
        {"queue_time_p99_s": float|None, "ttft_p99_s": float|None,
        "prefill_backlog_tokens": float, "window_complete": bool,
        "decode_saturated": bool, "slo_burn_rate": float|None (the
        SLOBurnRateMonitor's shortest-window burn, when one feeds this
        deployment)}. A None percentile means the window saw
        no samples for that signal — hot never fires on silence, cold
        treats silence as idle; backlog > 0 or decode saturation (every
        decode slot busy — histograms only sample at admission, so a
        decode-bound stretch is silent) still block scale-down, so
        saturated-but-silent engines keep their replicas."""
        if current <= 0:
            return self.min_replicas
        hot = False
        cold = bool(signals.get("window_complete"))
        for observed, target in (
            (signals.get("queue_time_p99_s"), self.target_queue_time_p99_s),
            (signals.get("ttft_p99_s"), self.target_ttft_p99_s),
        ):
            if target is None or observed is None:
                continue
            if observed > target:
                hot = True
            if observed >= self.downscale_margin * target:
                cold = False
        burn = signals.get("slo_burn_rate")
        if self.target_burn_rate is not None and burn is not None:
            if burn > self.target_burn_rate:
                hot = True
            if burn >= self.downscale_margin * self.target_burn_rate:
                cold = False
        backlog = float(signals.get("prefill_backlog_tokens", 0.0) or 0.0)
        if (
            self.max_prefill_backlog_per_replica is not None
            and backlog / current > self.max_prefill_backlog_per_replica
        ):
            hot = True
        if backlog > 0:
            cold = False  # outstanding prompt work: never shrink into it
        if signals.get("decode_saturated"):
            # Decode-bound stretches produce NO admission-time histogram
            # samples — every decode slot busy must read as load, not as
            # the idle silence that legitimizes scale-down.
            cold = False
        if hot:
            return min(current + 1, self.max_replicas)
        if cold:
            return max(current - 1, self.min_replicas)
        return max(self.min_replicas, min(self.max_replicas, current))


@dataclass
class DeploymentConfig:
    """Per-deployment target config (reference: serve/config.py DeploymentConfig)."""

    num_replicas: int = 1
    max_concurrent_queries: int = 100
    # AutoscalingConfig (queue-depth policy) or LLMAutoscalingPolicy
    # (SLO-driven); None pins num_replicas.
    autoscaling_config: Optional[Any] = None
    user_config: Any = None
    ray_actor_options: dict = field(default_factory=dict)
    health_check_period_s: float = 1.0
    graceful_shutdown_timeout_s: float = 5.0
    # Client-side failover (handle/router): how many times one request may
    # be re-dispatched to another replica after an ActorDied/Unavailable
    # failure, and the initial delay of the exponential backoff between
    # attempts. Budget exhaustion raises the typed
    # ReplicaUnavailableRetryExhausted. NOTE: a replica can die AFTER
    # executing a request but before the reply lands, so failover gives
    # AT-LEAST-ONCE execution — set request_retry_budget=0 for deployments
    # whose handlers are not idempotent.
    request_retry_budget: int = DEFAULT_RETRY_BUDGET
    request_backoff_initial_s: float = DEFAULT_BACKOFF_INITIAL_S
    # Seed for the router's full-jitter backoff RNG. None (production)
    # seeds from entropy — decorrelated retry delays are the point of
    # jitter; tests pin it for reproducible delay sequences.
    request_backoff_jitter_seed: Optional[int] = None
    # Deployment-declared mid-stream failover policy: handles built from
    # this config (serve.run's return, get_app_handle — and therefore the
    # HTTP proxy's streaming path) resume interrupted streams through it,
    # so a replica dying or DRAINING mid-stream migrates HTTP clients'
    # streams too, not just handles that opted in explicitly. Must be a
    # picklable module-level callable with the stream_resume_fn contract
    # (args, kwargs, items_delivered) -> (args, kwargs) | None.
    stream_resume_fn: Optional[Callable] = None
    # Deployment-declared replica affinity: handles built from this config
    # compute `affinity_key_fn(args, kwargs) -> hashable | None` once per
    # request and prefer the rendezvous-hash replica for that key as a
    # tie-break over power-of-two-choices (never overriding drain,
    # exclusion, or capacity). For LLM deployments this is the KV
    # fabric's prefix affinity (llm.kvfabric.LLMPrefixAffinity) — requests
    # sharing a leading prompt block land where their KV cache (device or
    # fabric tier) already lives. Must be a picklable
    # module-level callable (or instance of a module-level class).
    affinity_key_fn: Optional[Callable] = None

    def initial_replicas(self) -> int:
        if self.autoscaling_config is not None:
            return max(self.autoscaling_config.min_replicas, 0)
        return self.num_replicas
