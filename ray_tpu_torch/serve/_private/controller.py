"""ServeController actor: declarative reconciliation of deployment state.

Reference: serve/controller.py:79 (ServeController; deploy_apps :483) +
serve/_private/deployment_state.py:1115,2073 (DeploymentState/Manager; scaling
:1493) + serve/_private/long_poll.py:68 (LongPollHost) +
serve/_private/autoscaling_policy.py (queue-metric autoscaling).

One controller actor per cluster (named, detached). A reconcile thread drives
every deployment toward its target: start/stop replicas, apply user_config via
reconfigure, health-check replicas, and autoscale — on windowed
ongoing-request counts (AutoscalingConfig) or on the engine's own SLO
histogram windows (LLMAutoscalingPolicy). Handles discover replicas through a
versioned snapshot + blocking listen_for_change (long-poll).

Replica lifecycle: STARTING → RUNNING → DRAINING → STOPPED. Scale-down is a
DRAIN, not a kill: the victim leaves the routing set (published to
long-pollers BEFORE any stop RPC, so routers never dispatch into the gap),
keeps serving its in-flight requests up to graceful_shutdown_timeout_s, and
interrupts whatever can't finish with a typed ReplicaDrainingError — which
the router treats as a planned migration, stream-resuming onto surviving
replicas through the stream_resume_fn machinery instead of waiting for an
ActorDiedError. Every transition lands in a bounded per-deployment state
history (the chaos tests' assertion surface) and in the
serve_deployment_replica_state / serve_replica_drain_seconds metrics.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque
from typing import Any, Optional

from ray_tpu_torch.serve.config import LLMAutoscalingPolicy
from ray_tpu_torch.util.metrics import Counter, Histogram, get_or_create

CONTROLLER_NAME = "SERVE_CONTROLLER"
RECONCILE_PERIOD_S = 0.05
# After a replica-start failure, wait this long before retrying the start
# (the reconcile loop runs every 50ms — without a backoff a deterministic
# constructor failure would hot-spin actor creation).
START_RETRY_BACKOFF_S = 0.5
# Extra time past graceful_shutdown_timeout_s for the drain poll to observe
# the replica's in-flight count hit zero after deadline interruptions.
DRAIN_POLL_GRACE_S = 2.0

REPLICA_STARTING = "STARTING"
REPLICA_RUNNING = "RUNNING"
REPLICA_DRAINING = "DRAINING"
REPLICA_STOPPED = "STOPPED"
REPLICA_STATES = (
    REPLICA_STARTING, REPLICA_RUNNING, REPLICA_DRAINING, REPLICA_STOPPED,
)

# Drain wall time spans sub-second empty drains to minute-long graceful
# timeouts: the request-scale 1-2.5-5 decade ladder (same convention as
# llm/observability REQUEST_SECONDS_BOUNDARIES).
DRAIN_SECONDS_BOUNDARIES = [
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
]


# How long an app's deletion or Serve's shutdown waits for its replicas'
# graceful stops (inside serve.shutdown()'s 30 s wait for the controller).
STOP_JOIN_S = 25.0


def _stop_replica_gracefully(handle, timeout_s: float) -> threading.Thread:
    """Run the replica's shutdown hook, THEN kill — off-thread so the
    reconcile loop never blocks on user cleanup code (reference:
    deployment_state.py graceful shutdown with graceful_shutdown_timeout_s).
    Used for application teardown; SCALE-DOWN goes through the drain
    protocol instead (ServeControllerActor._drain_replica_async). Returns
    the thread, so that an app's deletion can wait for its stops."""

    def stop():
        from ray_tpu_torch import api as ray

        try:
            ray.get(handle.prepare_for_shutdown.remote(), timeout=timeout_s)
        except Exception:
            pass
        try:
            ray.kill(handle)
        except Exception:
            pass

    thread = threading.Thread(target=stop, daemon=True, name="serve-replica-stop")
    thread.start()
    return thread


def _join_stops(threads: list, timeout_s: float) -> None:
    """Wait, under one deadline, for replica stops started by _stop_all.
    An app's deletion and Serve's shutdown return only once each replica's
    shutdown hook ran and the replica was killed: returning earlier let a
    caller shut the runtime down under a hook still running, and a replica
    that owned its engine (engine_per_replica) then left the engine's loop
    thread, and the engine's card memory, alive."""
    deadline = time.monotonic() + timeout_s
    for thread in threads:
        thread.join(timeout=max(0.0, deadline - time.monotonic()))


class _DeploymentState:
    """Target + observed state for one deployment. All fields are guarded
    by the owning controller's self._lock; methods suffixed `_locked` (and
    the read helpers the controller calls under its lock) assume it."""

    def __init__(self, app: str, name: str, info: dict):
        self.app = app
        self.name = name
        self.info = info  # callable_def, init_args, init_kwargs, config
        self.replicas: dict[str, Any] = {}  # tag -> ActorHandle (routable)
        self.draining: dict[str, Any] = {}  # tag -> ActorHandle (no routing)
        self.replica_states: dict[str, str] = {}  # tag -> lifecycle state
        # Bounded transition log: {"t", "tag", "state"} — the assertion
        # surface for autoscale/drain chaos tests and the dashboard.
        self.state_history: deque = deque(maxlen=512)
        self.replica_seq = 0
        self.status = "UPDATING"
        self.message = ""
        # Queue depth reported by each handle (handle_id -> count).
        self.handle_queued: dict[str, float] = {}
        self.last_metrics: dict[str, int] = {}  # tag -> ongoing
        # Autoscaling windows: (monotonic_t, total_ongoing) samples, and
        # per-engine (monotonic_t, autoscaling_snapshot) samples for the
        # SLO policy's histogram-window diffs.
        self.ongoing_window: deque = deque()
        self.engine_windows: dict[str, deque] = {}
        self.last_scale_up_t = 0.0
        self.last_scale_down_t = 0.0
        self.last_start_failure_t = 0.0
        self.num_drained_replicas = 0
        self.num_migrated_requests = 0

    @property
    def key(self) -> str:
        return f"{self.app}#{self.name}"

    def record_state_locked(self, tag: str, state: str) -> None:
        self.state_history.append(
            {"t": time.time(), "tag": tag, "state": state}
        )
        if state == REPLICA_STOPPED:
            self.replica_states.pop(tag, None)
        else:
            self.replica_states[tag] = state

    def look_back_s(self) -> float:
        auto = self.info["config"].autoscaling_config
        return float(getattr(auto, "look_back_period_s", 2.0) or 2.0)

    def observe_metrics_locked(
        self, now: float, total_ongoing: float, engine_snaps: list
    ) -> None:
        look = self.look_back_s()
        self.ongoing_window.append((now, float(total_ongoing)))
        _trim_window(self.ongoing_window, now - look)
        for snap in engine_snaps:
            eid = snap.get("engine_id")
            if not eid:
                continue
            dq = self.engine_windows.setdefault(eid, deque())
            dq.append((now, snap))
            _trim_window(dq, now - look)
        # Evict engines that stopped reporting (replaced/dead actor):
        # their frozen newest sample must not contribute backlog or
        # decode-saturation to the signals forever.
        stale_cutoff = now - max(3.0 * look, look + 5.0)
        for eid in list(self.engine_windows):
            dq = self.engine_windows[eid]
            if not dq or dq[-1][0] <= stale_cutoff:
                del self.engine_windows[eid]

    def windowed_ongoing(self, now: float) -> float:
        """Time-window average of the ongoing-requests metric — the
        flap-prevention substrate behind look_back_period_s: one bursty
        sample moves the average by 1/len(window), never by its own
        magnitude."""
        if not self.ongoing_window:
            return sum(self.last_metrics.values()) + sum(
                self.handle_queued.values()
            )
        cutoff = now - self.look_back_s()
        vals = [v for t, v in self.ongoing_window if t >= cutoff]
        if not vals:
            vals = [self.ongoing_window[-1][1]]
        return sum(vals) / len(vals)

    def llm_signals(self, policy: LLMAutoscalingPolicy, now: float) -> dict:
        """Windowed SLO signals for LLMAutoscalingPolicy: per-engine
        histogram deltas (newest sample minus the newest sample at or
        before the window start) merged across engines, plus the latest
        prefill backlog. window_complete is False until every reporting
        engine's retained samples span the full look-back — scale-down
        never acts on a partial window."""
        from ray_tpu_torch.util.metrics import percentile_from_buckets

        window_start = now - policy.look_back_period_s
        merged: dict[str, list] = {}
        backlog = 0.0
        num_running = 0
        decode_slots = 0
        complete = bool(self.engine_windows)
        for dq in self.engine_windows.values():
            if not dq:
                continue
            newest = dq[-1][1]
            backlog += float(newest.get("prefill_backlog_tokens", 0) or 0)
            num_running += int(newest.get("num_running", 0) or 0)
            decode_slots += int(newest.get("max_decode_slots", 0) or 0)
            base = None
            for t, snap in dq:
                if t <= window_start:
                    base = snap
                else:
                    break
            if base is None:
                base = dq[0][1]
                if dq[0][0] > window_start:
                    complete = False
            for field in ("queue_time", "ttft"):
                ns = newest.get(field)
                if not ns:
                    continue
                bs = (base.get(field) or {}).get(
                    "buckets", [0] * len(ns["buckets"])
                )
                delta = [max(a - b, 0) for a, b in zip(ns["buckets"], bs)]
                got = merged.get(field)
                if got is None:
                    merged[field] = [list(ns["boundaries"]), delta]
                elif got[0] == list(ns["boundaries"]):
                    got[1] = [x + y for x, y in zip(got[1], delta)]
        signals: dict = {
            "prefill_backlog_tokens": backlog,
            "window_complete": complete,
            # Saturated even when the admission-time histograms are silent
            # (decode-bound stretch: long generations, no new arrivals).
            "decode_saturated": decode_slots > 0
            and num_running >= decode_slots,
        }
        for field, label in (
            ("queue_time", "queue_time_p99_s"),
            ("ttft", "ttft_p99_s"),
        ):
            got = merged.get(field)
            signals[label] = (
                percentile_from_buckets(got[0], got[1], 99.0)
                if got is not None and sum(got[1])
                else None
            )
        return signals

    def target_replicas(
        self, now: Optional[float] = None, signals: Optional[dict] = None
    ) -> int:
        """`signals` lets a caller that already computed llm_signals (the
        observability snapshot) reuse them — the window merge runs under
        the controller lock the reconcile loop contends on."""
        cfg = self.info["config"]
        auto = cfg.autoscaling_config
        if auto is None:
            return cfg.num_replicas
        if now is None:
            now = time.monotonic()
        current = len(self.replicas)
        if isinstance(auto, LLMAutoscalingPolicy):
            if signals is None:
                signals = self.llm_signals(auto, now)
            desired = auto.desired_replicas(signals, current)
        else:
            desired = auto.desired_replicas(
                self.windowed_ongoing(now), max(current, 1)
            )
        # Cooldown hysteresis: one step per cooldown period per direction
        # (AutoscalingConfig has no cooldown attrs — the window alone
        # paces it, preserving its historical responsiveness).
        if desired > current and now - self.last_scale_up_t < getattr(
            auto, "upscale_cooldown_s", 0.0
        ):
            return current
        if desired < current and now - self.last_scale_down_t < getattr(
            auto, "downscale_cooldown_s", 0.0
        ):
            return current
        return desired


def _trim_window(dq: deque, cutoff: float) -> None:
    """Drop samples older than `cutoff`, keeping ONE pre-cutoff sample as
    the window-start baseline for histogram diffs."""
    while len(dq) >= 2 and dq[1][0] <= cutoff:
        dq.popleft()


class ServeControllerActor:
    def __init__(self):
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._apps: dict[str, dict[str, _DeploymentState]] = {}
        self._version = 0
        self._shutdown = False
        # Drain observability: wall time of DRAINING → STOPPED per
        # deployment, replicas drained, and requests interrupted at the
        # drain deadline (the replica's count, collected at stop time).
        self._m_drain_seconds = get_or_create(
            Histogram,
            "serve_replica_drain_seconds",
            "Wall time from a replica entering DRAINING to STOPPED",
            boundaries=DRAIN_SECONDS_BOUNDARIES,
            tag_keys=("app", "deployment"),
        )
        self._m_replicas_drained = get_or_create(
            Counter,
            "serve_deployment_replicas_drained",
            "Replicas taken through the graceful drain protocol",
            tag_keys=("app", "deployment"),
        )
        self._m_drained_requests = get_or_create(
            Counter,
            "serve_deployment_drained_requests",
            "In-flight streams interrupted at a drain deadline and handed "
            "to the router's stream-resume migration",
            tag_keys=("app", "deployment"),
        )
        self._reconcile_thread = threading.Thread(
            target=self._reconcile_loop, daemon=True, name="serve-reconcile"
        )
        self._reconcile_thread.start()

    # ---------------- deploy / delete ----------------

    def deploy_application(self, app_name: str, deployments: list[dict]) -> None:
        """Set an application's target state (reference: controller.py:483
        deploy_apps). Each dict: {name, callable_def, init_args, init_kwargs,
        config}."""
        with self._lock:
            old = self._apps.get(app_name, {})
            new: dict[str, _DeploymentState] = {}
            for d in deployments:
                name = d["name"]
                existing = old.get(name)
                if existing is not None and self._same_code(existing.info, d):
                    # In-place update: keep replicas; reconcile applies config.
                    existing.info = d
                    existing.status = "UPDATING"
                    new[name] = existing
                    # Push new user_config to live replicas.
                    if d["config"].user_config is not None:
                        for h in list(existing.replicas.values()):
                            try:
                                # ray-tpu: lint-ignore[RTL401] deliberate
                                # fire-and-forget: config push must not
                                # block the deploy RPC; a replica that
                                # missed it fails health checks and is
                                # replaced with the new config anyway
                                h.reconfigure.remote(d["config"].user_config)
                            except Exception:
                                pass
                else:
                    if existing is not None:
                        self._stop_all(existing)
                    new[name] = _DeploymentState(app_name, name, d)
            for name, st in old.items():
                if name not in new:
                    self._stop_all(st)
            self._apps[app_name] = new
            self._bump()

    @staticmethod
    def _same_code(old_info: dict, new_info: dict) -> bool:
        return old_info.get("code_version") == new_info.get("code_version")

    def delete_application(self, app_name: str) -> None:
        stops = []
        with self._lock:
            app = self._apps.pop(app_name, None)
            if app:
                for st in app.values():
                    stops += self._stop_all(st)
            self._bump()
        _join_stops(stops, STOP_JOIN_S)

    def graceful_shutdown(self) -> None:
        stops = []
        with self._lock:
            for app in self._apps.values():
                for st in app.values():
                    stops += self._stop_all(st)
            self._apps.clear()
            self._shutdown = True
            self._bump()
        _join_stops(stops, STOP_JOIN_S)

    def set_target_replicas(
        self, app: str, deployment: str, num_replicas: int
    ) -> bool:
        """Imperative scale target (serve.scale_deployment). Scale-down
        from here drains exactly like an autoscaler decision. Returns
        False when the deployment is unknown."""
        import dataclasses

        with self._lock:
            st = self._get_state(app, deployment)
            if st is None:
                return False
            st.info["config"] = dataclasses.replace(
                st.info["config"], num_replicas=int(num_replicas)
            )
            st.status = "UPDATING"
            return True

    # ---------------- discovery (long poll) ----------------

    def get_replica_snapshot(self, app: str, deployment: str) -> tuple[int, dict]:
        """Returns (version, {replica_tag: ActorHandle, ...}). DRAINING
        replicas are NOT in the snapshot — they finish their in-flight
        work but take no new dispatches."""
        with self._lock:
            st = self._get_state(app, deployment)
            if st is None:
                return self._version, {}
            return self._version, dict(st.replicas)

    def get_deployment_config(self, app: str, deployment: str):
        """The deployment's target DeploymentConfig, or None if unknown —
        lets late-bound handles (serve.get_deployment_handle) honor the
        configured retry/backoff knobs like serve.run handles do."""
        with self._lock:
            st = self._get_state(app, deployment)
            return None if st is None else st.info["config"]

    def listen_for_change(self, known_version: int, timeout_s: float = 10.0):
        """Block until cluster state version advances past known_version
        (reference long-poll: serve/_private/long_poll.py:186).

        Monotonic deadline: a backward NTP step used to recede the
        wall-clock deadline and park the poller (and its actor thread)
        far past timeout_s (found by lint RTL302)."""
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while self._version <= known_version and not self._shutdown:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            return self._version

    def _bump(self) -> None:
        self._version += 1
        self._cv.notify_all()

    # ---------------- metrics ----------------

    def record_handle_metrics(
        self, app: str, deployment: str, handle_id: str, queued: float
    ) -> None:
        with self._lock:
            st = self._get_state(app, deployment)
            if st is not None:
                st.handle_queued[handle_id] = queued

    # ---------------- status / observability ----------------

    def get_status(self) -> dict:
        with self._lock:
            out: dict[str, Any] = {}
            now = time.monotonic()
            for app_name, app in self._apps.items():
                out[app_name] = {
                    name: {
                        "status": st.status,
                        "message": st.message,
                        "num_replicas": len(st.replicas),
                        "num_draining": len(st.draining),
                        "target_replicas": st.target_replicas(now),
                    }
                    for name, st in app.items()
                }
            return out

    def get_observability(self) -> dict:
        """Replica lifecycle view for the dashboard /api/serve panel and
        the scrape-time gauge refresh: per-deployment state counts, the
        transition history tail, drain totals, and (for SLO-autoscaled
        deployments) the current windowed signals."""
        with self._lock:
            out: dict[str, Any] = {}
            now = time.monotonic()
            for app_name, app in self._apps.items():
                deps = out.setdefault(app_name, {})
                for name, st in app.items():
                    counts = {state: 0 for state in REPLICA_STATES}
                    for state in st.replica_states.values():
                        counts[state] = counts.get(state, 0) + 1
                    auto = st.info["config"].autoscaling_config
                    signals = (
                        st.llm_signals(auto, now)
                        if isinstance(auto, LLMAutoscalingPolicy)
                        else None
                    )
                    deps[name] = {
                        "status": st.status,
                        "message": st.message,
                        "target_replicas": st.target_replicas(
                            now, signals=signals
                        ),
                        "replica_states": dict(st.replica_states),
                        "state_counts": counts,
                        "num_drained_replicas": st.num_drained_replicas,
                        "num_migrated_requests": st.num_migrated_requests,
                        "autoscaling_signals": signals,
                        "history": list(st.state_history)[-50:],
                    }
            return out

    def get_replica_state_history(self, app: str, deployment: str) -> list:
        """Full retained transition log for one deployment (chaos tests
        assert scale events from this)."""
        with self._lock:
            st = self._get_state(app, deployment)
            return [] if st is None else list(st.state_history)

    # ---------------- reconciliation ----------------

    def _get_state(self, app: str, deployment: str) -> Optional[_DeploymentState]:
        """Caller must hold self._lock."""
        return self._apps.get(app, {}).get(deployment)

    def _reconcile_loop(self) -> None:
        # ray-tpu: lint-ignore[RTL201] daemon-loop poll of an atomic bool;
        # a stale read only delays exit by one reconcile period
        while not self._shutdown:
            try:
                self._reconcile_once()
            except Exception:
                traceback.print_exc()
            time.sleep(RECONCILE_PERIOD_S)

    def _reconcile_once(self) -> None:
        with self._lock:
            states = [
                st for app in self._apps.values() for st in app.values()
            ]
        for st in states:
            self._poll_metrics(st)
            self._health_check(st)
            self._scale(st)

    def _health_check(self, st: "_DeploymentState") -> None:
        """Probe user check_health on the deployment's configured period;
        a False return or a dead actor drops the replica (scaling replaces
        it). Reference: deployment_state.py replica health checking.
        DRAINING replicas are not probed — they are leaving anyway, and a
        dead one surfaces to clients as the ActorDiedError failover path."""
        from ray_tpu_torch import api as ray
        from ray_tpu_torch.exceptions import ActorDiedError

        cfg = st.info["config"]
        period = float(getattr(cfg, "health_check_period_s", 1.0) or 0)
        if period <= 0:
            return
        timeout_threshold = int(
            getattr(cfg, "health_check_failure_threshold", 3) or 3
        )
        if not hasattr(st, "last_health"):
            st.last_health = {}
            st.health_timeouts = {}
        now = time.time()
        due = {}
        with self._lock:
            for tag, h in st.replicas.items():
                if now - st.last_health.get(tag, 0.0) >= period:
                    st.last_health[tag] = now
                    try:
                        due[tag] = h.check_health.remote()
                    except Exception:
                        pass
        if not due:
            return
        # Wait on all probes COLLECTIVELY: one slow replica must not stall
        # the control loop for 2s x replicas (reference waits on the whole
        # batch, deployment_state.py health checking).
        ready, _ = ray.wait(list(due.values()), num_returns=len(due), timeout=2.0)
        ready_set = set(ready)
        for tag, ref in due.items():
            healthy = True
            if ref in ready_set:
                try:
                    healthy = bool(ray.get(ref, timeout=0))
                    if healthy:
                        st.health_timeouts[tag] = 0
                except ActorDiedError:
                    healthy = False  # dead process: immediately fatal
                except Exception:
                    # The check itself raised: count toward the same
                    # consecutive-failure threshold as timeouts (one
                    # transient raise must not churn the replica).
                    misses = st.health_timeouts.get(tag, 0) + 1
                    st.health_timeouts[tag] = misses
                    healthy = misses < timeout_threshold
            else:
                # Timed out: transient a few times, dead past the threshold —
                # a hung-but-alive replica must eventually be replaced
                # (timeouts treated as transient forever never replace it).
                misses = st.health_timeouts.get(tag, 0) + 1
                st.health_timeouts[tag] = misses
                healthy = misses < timeout_threshold
            if not healthy:
                with self._lock:
                    h = st.replicas.pop(tag, None)
                    st.last_health.pop(tag, None)
                    st.health_timeouts.pop(tag, None)
                    if h is not None:
                        st.record_state_locked(tag, REPLICA_STOPPED)
                    self._bump()
                if h is not None:
                    try:
                        ray.kill(h)
                    except Exception:
                        pass

    def _poll_metrics(self, st: _DeploymentState) -> None:
        from ray_tpu_torch import api as ray

        refs = {}
        with self._lock:
            for tag, h in st.replicas.items():
                try:
                    refs[tag] = h.get_metrics.remote()
                except Exception:
                    pass
        from ray_tpu_torch.exceptions import ActorDiedError

        metrics = {}
        engine_snaps = []
        for tag, ref in refs.items():
            try:
                m = ray.get(ref, timeout=2.0)
                metrics[tag] = int(m["num_ongoing_requests"])
                snap = m.get("autoscaling")
                if isinstance(snap, dict) and snap:
                    engine_snaps.append(snap)
            except ActorDiedError:
                # Replica actually died: drop it; scaling replaces it.
                with self._lock:
                    if st.replicas.pop(tag, None) is not None:
                        st.record_state_locked(tag, REPLICA_STOPPED)
                    self._bump()
            except Exception:
                # Timeout / transient (e.g. constructor still running): keep
                # the replica and carry forward its last known metric —
                # dropping here would spawn duplicates for every slow-init
                # deployment.
                with self._lock:
                    if tag in st.last_metrics:
                        metrics[tag] = st.last_metrics[tag]
        with self._lock:
            st.last_metrics = metrics
            total = sum(metrics.values()) + sum(st.handle_queued.values())
            st.observe_metrics_locked(
                time.monotonic(), total, engine_snaps
            )

    def _scale(self, st: _DeploymentState) -> None:
        now = time.monotonic()
        with self._lock:
            if self._shutdown or self._get_state(st.app, st.name) is not st:
                # This pass captured the deployment before a shutdown or
                # delete emptied its replicas: starting one now would run
                # its constructor after its app is gone (ROADMAP §D10).
                return
            target = st.target_replicas(now)
            current = len(st.replicas)
            cfg = st.info["config"]
            if current == target:
                if st.status != "HEALTHY":
                    st.status = "HEALTHY"
                    st.message = ""
                    self._bump()
                return
            if current < target:
                if now - st.last_start_failure_t < START_RETRY_BACKOFF_S:
                    return  # back off between failed start attempts
                specs = []
                for _ in range(target - current):
                    tag = f"{st.key}#{st.replica_seq}"
                    st.replica_seq += 1
                    st.record_state_locked(tag, REPLICA_STARTING)
                    specs.append(tag)
                st.last_scale_up_t = now
            else:
                victims = self._begin_drain_locked(st, current - target)
                st.last_scale_down_t = now
                # The routing set is at target the moment the victims
                # leave it — the deployment is HEALTHY now, not after the
                # next reconcile pass happens to observe it (draining
                # replicas are lifecycle bookkeeping, not capacity).
                st.status = "HEALTHY"
                st.message = ""
                # Publish the shrunk routing set to long-pollers BEFORE any
                # drain/stop RPC is issued: routers must stop dispatching
                # to the victims before the victims start refusing work
                # (the pre-drain code bumped after the stop calls, leaving
                # a window where a router could dispatch to a dying
                # replica it had no reason to avoid).
                self._bump()
        if current > target:
            for tag, h in victims:
                self._drain_replica_async(
                    st, tag, h, cfg.graceful_shutdown_timeout_s
                )
            return
        # Start new replicas outside the lock (actor creation can be slow).
        from ray_tpu_torch.actor import ActorClass
        from ray_tpu_torch.serve._private.replica import ReplicaActor

        replica_cls = ActorClass(
            ReplicaActor,
            {
                # +2 headroom over the request slots: control-plane RPCs
                # (drain, health, metrics) must never starve behind a full
                # complement of in-flight streams.
                "max_concurrency": max(2, cfg.max_concurrent_queries) + 2,
                **cfg.ray_actor_options,
            },
        )
        from ray_tpu_torch._private.fault_injection import maybe_fail

        started = {}
        failure: Optional[tuple] = None
        for tag in specs:
            try:
                maybe_fail("controller.start_replica", detail=tag)
                h = replica_cls.remote(
                    st.name,
                    tag,
                    st.info["callable_def"],
                    st.info["init_args"],
                    st.info["init_kwargs"],
                    cfg.user_config,
                    collect_autoscaling_metrics=isinstance(
                        cfg.autoscaling_config, LLMAutoscalingPolicy
                    ),
                )
                started[tag] = h
            except Exception as e:
                failure = (tag, e)
                break
        with self._lock:
            if self._get_state(st.app, st.name) is not st:
                # The app was deleted/redeployed while the lock was
                # released for actor creation: committing into the
                # orphaned state object would leak live replicas no
                # teardown path can ever reach. Stop them instead.
                for tag, h in started.items():
                    _stop_replica_gracefully(
                        h, cfg.graceful_shutdown_timeout_s
                    )
                    st.record_state_locked(tag, REPLICA_STOPPED)
                return
            st.replicas.update(started)
            for tag in started:
                st.record_state_locked(tag, REPLICA_RUNNING)
            if failure is not None:
                _, exc = failure
                # EVERY minted-but-unstarted tag gets a terminal state —
                # the failing one and the ones the break abandoned; the
                # next pass retries under fresh tags, and phantom
                # STARTING entries must not haunt the state gauges.
                for tag in specs:
                    if tag not in started:
                        st.record_state_locked(tag, REPLICA_STOPPED)
                st.last_start_failure_t = time.monotonic()
                if st.replicas:
                    # Live replicas keep serving: a failed scale-up must
                    # degrade gracefully — stay HEALTHY at the current
                    # count and retry after the backoff, never wedge in
                    # DEPLOY_FAILED while traffic is being served.
                    st.status = "HEALTHY"
                    st.message = f"scale-up failed, retrying: {exc}"
                else:
                    st.status = "DEPLOY_FAILED"
                    st.message = str(exc)
            self._bump()

    # ---------------- drain protocol ----------------

    def _begin_drain_locked(self, st: _DeploymentState, n: int) -> list:
        """Move the `n` least-loaded replicas from the routing set into
        DRAINING. Caller must hold self._lock and bump afterwards."""
        order = sorted(st.replicas, key=lambda t: st.last_metrics.get(t, 0))
        victims = []
        for tag in order[:n]:
            h = st.replicas.pop(tag)
            st.draining[tag] = h
            st.record_state_locked(tag, REPLICA_DRAINING)
            if hasattr(st, "last_health"):
                st.last_health.pop(tag, None)
                st.health_timeouts.pop(tag, None)
            victims.append((tag, h))
        return victims

    def _drain_replica_async(
        self, st: _DeploymentState, tag: str, handle, timeout_s: float
    ) -> None:
        """Drain one DRAINING replica off-thread: tell it to stop taking
        work and to interrupt whatever outlives `timeout_s`, wait for its
        in-flight count to reach zero, then run the shutdown hook and
        kill. Any failure in the drain conversation degrades to the plain
        stop path — in-flight requests then surface ActorDiedError to the
        router, which fails them over exactly as before this protocol
        existed (chaos site: controller.drain_replica)."""

        def drain():
            from ray_tpu_torch import api as ray
            from ray_tpu_torch._private.fault_injection import maybe_fail

            t0 = time.monotonic()
            migrated = 0
            try:
                maybe_fail("controller.drain_replica", detail=tag)
                ray.get(
                    handle.drain.remote(timeout_s),
                    timeout=max(min(timeout_s, 5.0), 0.5),
                )
                deadline = t0 + timeout_s + DRAIN_POLL_GRACE_S
                while time.monotonic() < deadline:
                    m = ray.get(handle.get_metrics.remote(), timeout=2.0)
                    migrated = int(m.get("num_drain_interrupted", 0))
                    if int(m.get("num_ongoing_requests", 0)) == 0:
                        break
                    time.sleep(0.02)
            except Exception:
                pass  # degrade to stop; client failover covers the rest
            try:
                ray.get(handle.prepare_for_shutdown.remote(), timeout=5.0)
            except Exception:
                pass
            try:
                ray.kill(handle)
            except Exception:
                pass
            duration = time.monotonic() - t0
            with self._lock:
                completed = st.draining.pop(tag, None) is not None
                if completed:
                    st.record_state_locked(tag, REPLICA_STOPPED)
                    st.num_drained_replicas += 1
                    st.num_migrated_requests += migrated
            if completed:
                # Only drains that RAN to completion count — one that lost
                # the race to app teardown (_stop_all already popped the
                # tag) must not skew the duration histogram or over-count
                # vs the controller's own num_drained_replicas. App-tagged:
                # same-named deployments in different apps (every build_app
                # names its ingress "LLMIngress") must not merge series.
                dep_tags = {"app": st.app, "deployment": st.name}
                self._m_drain_seconds.observe(duration, tags=dep_tags)
                self._m_replicas_drained.inc(tags=dep_tags)
                if migrated:
                    self._m_drained_requests.inc(migrated, tags=dep_tags)

        threading.Thread(
            target=drain, daemon=True, name=f"serve-replica-drain-{tag}"
        ).start()

    def _stop_all(self, st: _DeploymentState) -> list:
        """Caller must hold self._lock. Teardown (app delete/shutdown)
        stops RUNNING and DRAINING replicas alike — a deleted app has no
        surviving replicas to migrate onto. Returns the stop threads."""
        timeout = st.info["config"].graceful_shutdown_timeout_s
        stops = []
        for tag, h in list(st.replicas.items()) + list(st.draining.items()):
            stops.append(_stop_replica_gracefully(h, timeout))
            st.record_state_locked(tag, REPLICA_STOPPED)
        st.replicas.clear()
        st.draining.clear()
        return stops

    def ping(self) -> str:
        return "pong"


def get_controller():
    """The cluster's controller handle, or None when Serve is not running.
    Routers look the controller up this way and never start one: a router
    that outlives serve.shutdown() must not bring a controller back."""
    from ray_tpu_torch import api as ray
    from ray_tpu_torch.actor import ActorHandle

    runtime = ray.get_runtime()
    existing = runtime.controller.get_named_actor(
        CONTROLLER_NAME, runtime.namespace
    )
    return None if existing is None else ActorHandle(existing, "ServeControllerActor")


def get_or_create_controller():
    """Get the cluster's controller handle, starting it if needed."""
    from ray_tpu_torch import api as ray
    from ray_tpu_torch.actor import ActorClass

    existing = get_controller()
    if existing is not None:
        return existing
    cls = ActorClass(
        ServeControllerActor,
        {
            "name": CONTROLLER_NAME,
            "get_if_exists": True,
            "lifetime": "detached",
            "max_concurrency": 64,
        },
    )
    handle = cls.remote()
    ray.get(handle.ping.remote(), timeout=30.0)
    return handle
