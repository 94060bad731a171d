"""Knob-space sweep: the serving record producer and loadgen CLI.

Walks the serving knobs the stack has accumulated (attn_impl ×
kv_cache_dtype × speculation × prefix caching × chunked prefill × the
async step loop) at several open-loop arrival rates, each cell driving
the REAL serving path (serve.build_app → router → LLMIngress replica →
shared engine actor) with a seeded mixed scenario, and returns a record:
per-cell TTFT/TPOT p50/p99, achieved vs offered rate, error counts,
engine-histogram cross-check, and SLO verdicts.

Every cell also runs the gate pair — a deliberately-loose SLO that must
PASS and a deliberately-impossible one that must FAIL — so the SLO
machinery itself is asserted end-to-end on every run (`sweep --quick` is
the short version).

What the port changes against the reference's sweep:

* Device. The cell functions, `run_sweep` and `main` take `device=`
  (`--device`): "cuda" by default, which raises without CUDA; "cpu" only
  when asked. It goes to `build_app(device=...)`, and every record states
  its device (`run_sweep`'s also the card's name).
* The model. The reference's cells serve only `serve_model_config()`
  (vocab 128, 2 layers, width 64, f32, plain attention), on which no
  kernel runs. The cell functions and `run_sweep` take `model_config=`,
  `params=` (host weights), `engine_base=` (replaces BASE_ENGINE) and
  `scenario_overrides=` (to `ScenarioSpec.for_engine`, with the vocab
  taken from the model), so the same cells carry GPT-2 at full width on
  the card. With all four at None each cell is the reference's, field
  for field; each cell record also states the model, engine base and
  scenario it ran.
* The kernel row. The reference's `pallas_interpret` row (its kernel in
  interpret mode on a CPU) has no counterpart: the port's kernels have no
  CPU mode. In its place the `cuda` row names the hand-written kernels
  (attn_impl="cuda"); on the CPU naming it raises, and `run_sweep` with
  `configs=None` leaves it out and says so in the record's note.
* Teardown. Each cell ends its app, then its engines' loops, then its
  engines, and the KV-fabric pair also kills its fabric's store actor, so
  that nothing of a cell outlives it (`_teardown`, ROADMAP §D8).
* Where the record goes. `sweep` writes only to the `--out` it is given.

Entry point: `python -m ray_tpu_torch.loadgen.sweep run|sweep|report`,
or `python -m ray_tpu_torch.scripts.cli loadgen ...`, which forwards here.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional, Sequence, Tuple

RECORD_SERIES = "BENCH_SERVE"

# Engine geometry shared by every cell: small enough that warmup is
# seconds on CPU, big enough that the mixed scenario exercises chunking,
# preemption pressure, and multi-block prompts (max_model_len = 64).
BASE_ENGINE = dict(
    block_size=8,
    num_blocks=96,
    max_decode_slots=8,
    max_blocks_per_seq=8,
)

# (label, EngineConfig overrides, cpu_parity_only). Labels are stable:
# they key the trajectory across records. No row of the port is
# parity-only: its kernels run only on the card.
KNOB_CONFIGS: Tuple[Tuple[str, dict, bool], ...] = (
    ("base", {}, False),
    ("no_prefix_cache", {"enable_prefix_caching": False}, False),
    ("no_chunked_prefill", {"max_prefill_tokens_per_step": 0}, False),
    (
        "spec_ngram",
        {"speculation": "ngram", "num_speculative_tokens": 4},
        False,
    ),
    ("int8_kv", {"kv_cache_dtype": "int8"}, False),
    # Async double-buffered step loop: dispatch N+1 while N's values are
    # still in flight; token-identical to base, host gap ~0 when chained.
    ("async_step", {"async_scheduling": True}, False),
    # The hand-written kernels by name, in place of the reference's
    # interpret-mode row: they have no CPU mode, so this row needs the
    # card (see _cell_device).
    ("cuda", {"attn_impl": "cuda"}, False),
)

KERNEL_ROW = "cuda"


def serve_model_config():
    """The small GPT every cell serves by default (seed-initialized
    weights; the cells measure the serving machinery, not model
    quality). `model_config=` replaces it, e.g. with GPT-2 on the card."""
    import torch

    from ray_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(
        vocab_size=128,
        num_layers=2,
        num_heads=4,
        embed_dim=64,
        max_seq_len=128,
        dtype=torch.float32,
        attention_impl="reference",
    )


def _cell_device(device, overrides: Optional[dict] = None) -> str:
    """The sweep's device rule: "cuda" by default, which raises without
    CUDA; "cpu" only when the caller asks. The kernel row names the
    card's kernels, which have no CPU mode, so it refuses the CPU."""
    from ray_tpu_torch._private.device import resolve_device

    dev = str(resolve_device(device))
    if dev == "cpu" and (overrides or {}).get("attn_impl") == "cuda":
        raise ValueError(
            f"the {KERNEL_ROW!r} row (attn_impl='cuda') runs the "
            "hand-written CUDA kernels, which run only on the card (an "
            "NVIDIA H100) and have no CPU mode; run it with device='cuda'"
        )
    return dev


def _engine_base(engine_base: Optional[dict]) -> dict:
    return dict(BASE_ENGINE if engine_base is None else engine_base)


def _scenario(
    ecfg,
    name: str,
    num_requests: int,
    seed: int,
    model_config,
    scenario_overrides: Optional[dict],
    **fixed,
):
    """ScenarioSpec.for_engine for the engine `ecfg` configures, with the
    vocab of the served model and `scenario_overrides` under the cell's
    own `fixed` choices."""
    from ray_tpu_torch.loadgen.scenarios import ScenarioSpec

    return ScenarioSpec.for_engine(
        ecfg.max_model_len,
        ecfg.buckets()[-1],
        vocab_size=model_config.vocab_size,
        name=name,
        num_requests=num_requests,
        seed=seed,
        **{**(scenario_overrides or {}), **fixed},
    )


def _build_scenario(
    num_requests: int,
    seed: int,
    *,
    model_config=None,
    engine_base: Optional[dict] = None,
    scenario_overrides: Optional[dict] = None,
):
    from ray_tpu_torch.llm.config import EngineConfig

    return _scenario(
        EngineConfig(**_engine_base(engine_base)),
        "mixed",
        num_requests,
        seed,
        model_config or serve_model_config(),
        scenario_overrides,
    )


def _model_summary(cfg) -> dict:
    """What a cell served, for its record."""
    return {
        "vocab_size": cfg.vocab_size,
        "num_layers": cfg.num_layers,
        "num_heads": cfg.num_heads,
        "embed_dim": cfg.embed_dim,
        "dtype": str(cfg.dtype).replace("torch.", ""),
        "attention_impl": cfg.attention_impl,
    }


def _served(device, model_config, engine_base, spec) -> dict:
    """The record fields that say what a cell ran."""
    return {
        "device": device,
        "model": _model_summary(model_config),
        "engine_base": engine_base,
        "scenario": spec.to_dict(),
    }


def _live_actors(prefix: str) -> dict:
    """Name -> handle of every ALIVE named actor whose name starts with
    `prefix`."""
    import ray_tpu_torch
    from ray_tpu_torch._private.runtime import get_runtime

    out = {}
    for rec in get_runtime().controller.list_actors():
        name = getattr(rec, "name", None)
        if name and name.startswith(prefix) and rec.state.value == "ALIVE":
            out[name] = ray_tpu_torch.get_actor(name)
    return out


def _teardown(
    engine_name: str,
    per_replica: bool = False,
    fabric_name: Optional[str] = None,
) -> None:
    """End a cell: its app first, then its engines, each of whose loop is
    shut down before the actor is killed, then its KV fabric's store
    actor. The reference kills the engine first and its loop never: a
    replica whose health check then finds the engine gone is replaced, the
    replacement creates the engine anew (get_if_exists) and it outlives
    the cell; and a killed actor's loop thread keeps its engine, the card
    memory of its weights and pools included (ROADMAP §D8). A per-replica
    cell's engines are `llm_engine:{engine_name}-<suffix>`; the store,
    named `kv_fabric:{fabric_name}`, outlives every engine by design, so
    it is killed last."""
    import ray_tpu_torch
    from ray_tpu_torch import serve

    serve.shutdown()
    if per_replica:
        engines = list(_live_actors(f"llm_engine:{engine_name}-").values())
    else:
        try:
            engines = [ray_tpu_torch.get_actor(f"llm_engine:{engine_name}")]
        except Exception:
            engines = []  # engine never came up / already gone
    for engine in engines:
        try:
            ray_tpu_torch.get(engine.shutdown.remote(), timeout=30.0)
        except Exception:
            pass  # a dead or wedged engine: the kill below still lands
        try:
            ray_tpu_torch.kill(engine)
        except Exception:
            pass  # the replica's own teardown already reaped it
    if fabric_name is not None:
        try:
            store = ray_tpu_torch.get_actor(f"kv_fabric:{fabric_name}")
        except Exception:
            return  # no engine ever created the store
        ray_tpu_torch.kill(store)


def _drain_engine(handle, timeout_s: float = 60.0) -> dict:
    """Wait until the engine has no queued/running work, then return its
    final stats (the post-run pool/cache/speculation story)."""
    metrics = handle.options(method_name="metrics")
    deadline = time.monotonic() + timeout_s
    stats = {}
    while time.monotonic() < deadline:
        stats = metrics.remote().result(timeout_s=30.0)
        if stats.get("queue_depth", 0) == 0 and stats.get(
            "num_running", 0
        ) == 0:
            return stats
        time.sleep(0.25)
    return stats


def run_cell(
    label: str,
    overrides: dict,
    cpu_parity_only: bool,
    rate: float,
    num_requests: int,
    seed: int,
    arrival_process: str = "poisson",
    timeout_s: float = 30.0,
    *,
    device="cuda",
    model_config=None,
    params=None,
    engine_base: Optional[dict] = None,
    scenario_overrides: Optional[dict] = None,
) -> dict:
    """One sweep cell: deploy, prime, drive the open-loop schedule,
    report, gate, cross-check, tear down. Returns the cell record (the
    keyword arguments are the port's; see the module docstring)."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.config import EngineConfig
    from ray_tpu_torch.llm.serve import build_app
    from ray_tpu_torch.loadgen import report as report_mod
    from ray_tpu_torch.loadgen.arrivals import ArrivalSpec, arrival_times
    from ray_tpu_torch.loadgen.driver import run_open_loop
    from ray_tpu_torch.loadgen.scenarios import generate_requests
    from ray_tpu_torch.loadgen.slo import (
        IMPOSSIBLE_SLO,
        LOOSE_SLO,
        SLOSpec,
        evaluate_slo,
    )

    device = _cell_device(device, overrides)
    model_config = model_config or serve_model_config()
    base = _engine_base(engine_base)
    ecfg = EngineConfig(**{**base, **overrides})
    engine_name = f"loadgen-{label}-r{rate:g}-s{seed}"
    app_name = f"lg-{label}-r{rate:g}"
    handle = serve.run(
        build_app(
            model_config,
            ecfg,
            params=params,
            engine_name=engine_name,
            max_concurrent_queries=64,
            device=device,
        ),
        name=app_name,
        _blocking_timeout_s=300.0,
    )
    try:
        # Prime: one blocking request guarantees engine warmup finished
        # before the measured window opens (replica health reads True
        # while the engine actor is still warming its buckets).
        handle.remote(
            {"prompt_ids": [1, 2, 3], "max_new_tokens": 2}
        ).result(timeout_s=300.0)
        engine_id = handle.options(method_name="metrics").remote().result(
            timeout_s=30.0
        )["engine_id"]

        spec = _build_scenario(
            num_requests,
            seed,
            model_config=model_config,
            engine_base=base,
            scenario_overrides=scenario_overrides,
        )
        requests = generate_requests(spec)
        arrivals = ArrivalSpec(
            process=arrival_process, rate=rate, seed=seed
        )
        offsets = arrival_times(arrivals, len(requests))

        before = report_mod.engine_window(engine_id)
        result = run_open_loop(
            handle,
            requests,
            offsets,
            timeout_s=timeout_s,
            settle_timeout_s=max(timeout_s * 2, 60.0),
        )
        stats = _drain_engine(handle)
        after = report_mod.engine_window(engine_id)

        rep = report_mod.build_report(result)
        engine_pcts = report_mod.engine_percentiles(before, after)
        check = report_mod.cross_check(rep, engine_pcts, after)
        target_slo = SLOSpec.from_bounds(
            "cpu_interactive",
            ttft_p99=1.0,
            tpot_p99=0.25,
            e2e_p99=5.0,
            error_rate=0.25,
        )
        verdicts = {
            s.name: evaluate_slo(s, rep)
            for s in (LOOSE_SLO, IMPOSSIBLE_SLO, target_slo)
        }
        return {
            "config": label,
            "knobs": dict(overrides),
            "cpu_parity_only": cpu_parity_only,
            **_served(device, model_config, base, spec),
            "attn_impl": stats.get("attn_impl"),
            "kv_cache_dtype": stats.get("kv_cache_dtype"),
            "rate": rate,
            "arrival": arrivals.to_dict(),
            "report": rep,
            "engine_percentiles": engine_pcts,
            "cross_check": check,
            "slo": verdicts,
            "engine": {
                "wedged": stats.get("wedged"),
                "dead_letters": stats.get("num_dead_letters"),
                "kv_pool_allocated": stats.get("kv_pool_allocated"),
                "spec_draft_pool_allocated": stats.get(
                    "spec_draft_pool_allocated"
                ),
                "prefix_cache_hit_rate": stats.get(
                    "prefix_cache_hit_rate"
                ),
                "preemptions": stats.get("num_preemptions"),
                "spec_acceptance_rate": stats.get("spec_acceptance_rate"),
                "spec_tokens_per_verify_step": stats.get(
                    "spec_tokens_per_verify_step"
                ),
                "chunked_prefill_requests": stats.get(
                    "chunked_prefill_requests"
                ),
            },
        }
    finally:
        _teardown(engine_name)


def run_drain_cell(
    rate: float,
    num_requests: int,
    seed: int,
    timeout_s: float = 30.0,
    *,
    device="cuda",
    model_config=None,
    params=None,
    engine_base: Optional[dict] = None,
    scenario_overrides: Optional[dict] = None,
) -> dict:
    """The autoscaling/drain robustness cell: two ingress replicas over
    one shared engine, a scale-down to 1 fired MID-RUN under open-loop
    multiturn traffic (streams carry llm_stream_resume, so anything the
    drained replica can't finish migrates to the survivor). The gate
    asserts zero dropped requests, the KV + draft pools back at boot
    size, and exactly one replica taken DRAINING → STOPPED — the
    serving-robustness claim, re-proved on every run.

    The engine-histogram cross-check is deliberately NOT run here: a
    migrated stream is a second engine-side request, so engine
    percentiles legitimately disagree with client samples."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.config import EngineConfig
    from ray_tpu_torch.llm.serve import build_app, llm_stream_resume
    from ray_tpu_torch.loadgen import report as report_mod
    from ray_tpu_torch.loadgen.arrivals import ArrivalSpec, arrival_times
    from ray_tpu_torch.loadgen.driver import ScheduledEvent, run_open_loop
    from ray_tpu_torch.loadgen.scenarios import generate_requests
    from ray_tpu_torch.loadgen.slo import IMPOSSIBLE_SLO, LOOSE_SLO, evaluate_slo

    device = _cell_device(device)
    model_config = model_config or serve_model_config()
    base = _engine_base(engine_base)
    ecfg = EngineConfig(**base)
    engine_name = f"loadgen-drain-r{rate:g}-s{seed}"
    app_name = f"lg-drain-r{rate:g}"
    handle = serve.run(
        build_app(
            model_config,
            ecfg,
            params=params,
            engine_name=engine_name,
            num_replicas=2,
            max_concurrent_queries=64,
            graceful_shutdown_timeout_s=0.5,
            device=device,
        ),
        name=app_name,
        _blocking_timeout_s=300.0,
    )
    try:
        handle.remote(
            {"prompt_ids": [1, 2, 3], "max_new_tokens": 2}
        ).result(timeout_s=300.0)

        spec = _scenario(
            ecfg, "multiturn", num_requests, seed, model_config,
            scenario_overrides,
        )
        requests = generate_requests(spec)
        offsets = arrival_times(
            ArrivalSpec(process="uniform", rate=rate, seed=seed),
            len(requests),
        )
        scale_event = ScheduledEvent(
            offset_s=offsets[len(offsets) // 2],
            name="scale_down_2_to_1",
            fn=lambda: serve.scale_deployment(
                "LLMIngress", 1, app_name=app_name
            ),
        )
        result = run_open_loop(
            handle,
            requests,
            offsets,
            timeout_s=timeout_s,
            settle_timeout_s=max(timeout_s * 2, 60.0),
            events=[scale_event],
            stream_resume_fn=llm_stream_resume,
        )
        stats = _drain_engine(handle)
        drain_state = _await_drain_settled(app_name)

        rep = report_mod.build_report(result)
        verdicts = {
            s.name: evaluate_slo(s, rep)
            for s in (LOOSE_SLO, IMPOSSIBLE_SLO)
        }
        return {
            "config": "drain_scale_down",
            "knobs": {"num_replicas": "2->1 mid-run"},
            "cpu_parity_only": False,
            **_served(device, model_config, base, spec),
            "rate": rate,
            "report": rep,
            "slo": verdicts,
            "event": scale_event.to_dict(),
            "drain": drain_state,
            "engine": {
                "wedged": stats.get("wedged"),
                "dead_letters": stats.get("num_dead_letters"),
                "kv_pool_allocated": stats.get("kv_pool_allocated"),
                "spec_draft_pool_allocated": stats.get(
                    "spec_draft_pool_allocated"
                ),
                "prefix_cache_hit_rate": stats.get("prefix_cache_hit_rate"),
            },
        }
    finally:
        _teardown(engine_name)


def run_collapse_cell(
    rate: float,
    num_requests: int,
    seed: int,
    timeout_s: float = 30.0,
    *,
    device="cuda",
    model_config=None,
    params=None,
    engine_base: Optional[dict] = None,
    scenario_overrides: Optional[dict] = None,
) -> dict:
    """The overload-control cell: one replica, bounded admission
    (max_queue_len), driven with a ramp arrival process from `rate` to
    4x `rate` — past the engine's saturation point by design.
    An unbounded engine would enter queueing collapse here: the backlog
    grows without bound, every queued request's TTFT inherits the whole
    backlog ahead of it, and nothing recovers until the offered load
    stops. The control plane instead sheds what it cannot serve, so the
    gate asserts graceful degradation: accepted requests stay within the
    cell SLO, rejections are FAST (p99 rejection latency under the
    accepted TTFT p50 — shedding that costs a queue traversal is not
    shedding) and TYPED (every error is an OverloadedError shed, zero
    untyped failures), the engine never wedges, and the KV + draft pools
    drain back to boot size afterwards. Every request carries an
    end-to-end deadline (the driver's timeout_s), so the deadline plane
    is live under the same overload.

    The engine-histogram cross-check is deliberately NOT run: shed
    requests never reach the engine's histograms, so the two sides
    legitimately measure different populations."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.config import EngineConfig
    from ray_tpu_torch.llm.serve import build_app
    from ray_tpu_torch.loadgen import report as report_mod
    from ray_tpu_torch.loadgen.arrivals import ArrivalSpec, arrival_times
    from ray_tpu_torch.loadgen.driver import run_open_loop
    from ray_tpu_torch.loadgen.scenarios import generate_requests
    from ray_tpu_torch.loadgen.slo import (
        IMPOSSIBLE_SLO,
        LOOSE_SLO,
        SLOSpec,
        evaluate_slo,
    )

    device = _cell_device(device)
    model_config = model_config or serve_model_config()
    base = _engine_base(engine_base)
    # Backlog cap: one decode batch's worth of queued requests. Small
    # enough that the ramp MUST shed, big enough that steady sub-
    # saturation traffic never does.
    overrides = {"max_queue_len": base["max_decode_slots"]}
    ecfg = EngineConfig(**{**base, **overrides})
    # The ramp must land PAST saturation regardless of how fast the host
    # is: long decodes pin the service rate near
    # max_decode_slots / decode_time, and the peak arrival rate is
    # floored high enough that the backlog provably overruns the cap.
    num_requests = max(num_requests, 64)
    peak_rate = max(4.0 * rate, 400.0)
    engine_name = f"loadgen-collapse-r{rate:g}-s{seed}"
    app_name = f"lg-collapse-r{rate:g}"
    handle = serve.run(
        build_app(
            model_config,
            ecfg,
            params=params,
            engine_name=engine_name,
            max_concurrent_queries=64,
            device=device,
        ),
        name=app_name,
        _blocking_timeout_s=300.0,
    )
    try:
        handle.remote(
            {"prompt_ids": [1, 2, 3], "max_new_tokens": 2}
        ).result(timeout_s=300.0)

        # Clean long-decode traffic: no poison, no disconnects — under
        # overload the ONLY acceptable error class is a typed shed, so
        # the scenario must not inject failures of its own. Long outputs
        # hold decode slots, pinning the service rate well below the
        # ramp's peak.
        spec = _scenario(
            ecfg, "longtail", num_requests, seed, model_config,
            scenario_overrides,
            max_new_tokens=32,
            output_len_median=24.0,
            output_len_sigma=0.3,
        )
        requests = generate_requests(spec)
        arrivals = ArrivalSpec(
            process="ramp", rate=rate, ramp_to_rate=peak_rate, seed=seed
        )
        offsets = arrival_times(arrivals, len(requests))
        # Live burn-rate monitoring over the overload burst: a
        # discriminating spec pair sampled DURING the run (the engine
        # actor runs in this process, so the request histograms land in
        # this process's registry). The impossible spec must burn >1.0
        # while the ramp runs and the loose spec must not — the same
        # exercise-the-gate-machinery contract as the SLO verdict pair.
        from ray_tpu_torch.observability import SLOBurnRateMonitor

        burn_monitors = {
            s.name: SLOBurnRateMonitor(s, windows=(2.0, 10.0)).start(
                interval_s=0.25
            )
            for s in (LOOSE_SLO, IMPOSSIBLE_SLO)
        }
        try:
            result = run_open_loop(
                handle,
                requests,
                offsets,
                timeout_s=timeout_s,
                settle_timeout_s=max(timeout_s * 2, 60.0),
            )
        finally:
            burn_peaks = {}
            for mon_name, mon in burn_monitors.items():
                try:
                    mon.sample()  # final window before stopping
                finally:
                    mon.stop()
                burn_peaks[mon_name] = mon.peak_burn()
        stats = _drain_engine(handle)

        rep = report_mod.build_report(result)
        # Bounds on the ACCEPTED population only (sheds are expected and
        # carry no latency samples): bounded-admission queue wait is at
        # most max_queue_len prefills deep, which an unbounded queue at
        # 4x saturation would blow through within seconds of the ramp.
        collapse_slo = SLOSpec.from_bounds(
            "collapse_accepted", ttft_p99=5.0, tpot_p99=1.0
        )
        verdicts = {
            s.name: evaluate_slo(s, rep)
            for s in (LOOSE_SLO, IMPOSSIBLE_SLO, collapse_slo)
        }
        return {
            "config": "collapse_ramp",
            "knobs": {
                **overrides,
                "arrival": f"ramp to {peak_rate:g}/s past saturation",
            },
            "cpu_parity_only": False,
            **_served(device, model_config, base, spec),
            "rate": rate,
            "arrival": arrivals.to_dict(),
            "report": rep,
            "slo": verdicts,
            # Peak multi-window burn per monitored spec (sampled live
            # during the ramp — the alerting-signal analog of the
            # post-hoc SLO verdicts above).
            "burn_rates": burn_peaks,
            "engine": {
                "wedged": stats.get("wedged"),
                "dead_letters": stats.get("num_dead_letters"),
                "kv_pool_allocated": stats.get("kv_pool_allocated"),
                "spec_draft_pool_allocated": stats.get(
                    "spec_draft_pool_allocated"
                ),
                "shed_requests": stats.get("shed_requests"),
                "expired_requests": stats.get("expired_requests"),
                "max_queue_len": stats.get("max_queue_len"),
                "preemptions": stats.get("num_preemptions"),
            },
        }
    finally:
        _teardown(engine_name)


def _gate_collapse(cell: dict) -> List[str]:
    """Hard assertions for the collapse cell — the graceful-degradation
    claim: the overload MUST have shed (a ramp to 4x saturation that
    sheds nothing means the cap never bound), every error is a TYPED
    shed, accepted requests hold the cell SLO, rejections are cheaper
    than an accepted first token, no wedge, pools back at boot size."""
    from ray_tpu_torch.loadgen.report import is_shed_error

    tag = f"{cell['config']}@{cell['rate']}"
    rep = cell["report"]
    problems = []
    if rep["num_shed"] == 0:
        problems.append(
            f"{tag}: ramp past saturation shed nothing "
            "(bounded admission never bound)"
        )
    if rep["num_failures"] != 0:
        untyped = {
            k: v for k, v in rep["errors"].items() if not is_shed_error(k)
        }
        problems.append(
            f"{tag}: {rep['num_failures']} untyped failures under "
            f"overload ({untyped}) — sheds must be typed, nothing else "
            "may break"
        )
    if not cell["slo"]["collapse_accepted"]["passed"]:
        problems.append(
            f"{tag}: accepted requests broke the SLO under overload "
            f"({cell['slo']['collapse_accepted']['checks']})"
        )
    if cell["slo"]["impossible"]["passed"]:
        problems.append(f"{tag}: impossible SLO passed")
    burns = cell.get("burn_rates") or {}
    if not (burns.get("impossible", 0.0) > 1.0):
        problems.append(
            f"{tag}: impossible-SLO burn rate never exceeded 1.0 "
            f"({burns.get('impossible')}) — the live monitor missed an "
            "overload it cannot miss"
        )
    if not (burns.get("loose", float("inf")) < 1.0):
        problems.append(
            f"{tag}: loose-SLO burn rate hit {burns.get('loose')} — the "
            "monitor alerted on a spec this run cannot violate"
        )
    shed_p99 = rep["shed_latency_s"].get("p99")
    ttft_p50 = rep["percentiles"]["ttft_s"].get("p50")
    if shed_p99 is None or ttft_p50 is None or shed_p99 >= ttft_p50:
        problems.append(
            f"{tag}: rejections not fast (shed p99 {shed_p99} vs "
            f"accepted ttft p50 {ttft_p50})"
        )
    if cell["engine"].get("wedged"):
        problems.append(f"{tag}: engine wedged under overload")
    if cell["engine"].get("kv_pool_allocated") not in (0, None):
        problems.append(
            f"{tag}: KV pool did not drain "
            f"(allocated={cell['engine']['kv_pool_allocated']})"
        )
    if cell["engine"].get("spec_draft_pool_allocated") not in (0, None):
        problems.append(f"{tag}: draft mirror pool did not drain")
    if not cell["engine"].get("shed_requests"):
        problems.append(
            f"{tag}: engine recorded no sheds despite client-side sheds"
        )
    return problems


def run_kv_fabric_cell(
    affinity: bool,
    rate: float,
    num_requests: int,
    seed: int,
    timeout_s: float = 30.0,
    *,
    device="cuda",
    model_config=None,
    params=None,
    engine_base: Optional[dict] = None,
    scenario_overrides: Optional[dict] = None,
) -> dict:
    """The KV-fabric locality cell: two ingress replicas, EACH with its
    own engine (engine_per_replica), sharing one fabric — run twice by
    the sweep, prefix-affinity routing on vs off, over the multiturn
    scenario (sessions whose turn t+1 prompt extends turn t's).

    After the open-loop window the cell demotes every replica's cache to
    the fabric (the drain-path demotion, minus the drain), replays each
    session's final prompt through the router (client-timed — the
    affinity-on row shows the repeat landing on its session's device
    cache), and then serves one session's final prompt DIRECTLY on BOTH
    engines: at least one of the two never prefilled that whole prefix,
    so its blocks can only arrive through the fabric's host tier — the
    deterministic cross-replica hit the gate asserts. Zero dropped
    requests is gated like every cell."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.config import EngineConfig, KVFabricConfig
    from ray_tpu_torch.llm.serve import build_app
    from ray_tpu_torch.loadgen import report as report_mod
    from ray_tpu_torch.loadgen.arrivals import ArrivalSpec, arrival_times
    from ray_tpu_torch.loadgen.driver import run_open_loop
    from ray_tpu_torch.loadgen.scenarios import generate_requests
    from ray_tpu_torch.loadgen.slo import IMPOSSIBLE_SLO, LOOSE_SLO, evaluate_slo

    device = _cell_device(device)
    model_config = model_config or serve_model_config()
    base = _engine_base(engine_base)
    label = "kv_fabric_affinity" if affinity else "kv_fabric_p2c"
    fabric_name = f"{label}-r{rate:g}-s{seed}"
    ecfg = EngineConfig(
        **base,
        kv_fabric=KVFabricConfig(
            name=fabric_name,
            byte_budget=64 << 20,
            affinity=affinity,
        ),
    )
    engine_name = f"loadgen-{label}-r{rate:g}-s{seed}"
    app_name = f"lg-{label}-r{rate:g}"
    try:
        handle = serve.run(
            build_app(
                model_config,
                ecfg,
                params=params,
                engine_name=engine_name,
                num_replicas=2,
                engine_per_replica=True,
                max_concurrent_queries=64,
                device=device,
            ),
            name=app_name,
            _blocking_timeout_s=300.0,
        )
        handle.remote(
            {"prompt_ids": [1, 2, 3], "max_new_tokens": 2}
        ).result(timeout_s=300.0)

        spec = _scenario(
            ecfg, "multiturn", num_requests, seed, model_config,
            scenario_overrides,
        )
        requests = generate_requests(spec)
        offsets = arrival_times(
            ArrivalSpec(process="uniform", rate=rate, seed=seed),
            len(requests),
        )
        result = run_open_loop(
            handle,
            requests,
            offsets,
            timeout_s=timeout_s,
            settle_timeout_s=max(timeout_s * 2, 60.0),
        )
        rep = report_mod.build_report(result)

        engines = _live_actors(f"llm_engine:{engine_name}-")
        # Settle both engines (the shared-handle _drain_engine only sees
        # one replica's engine), then demote every cache to the fabric.
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            stats = [
                ray_tpu_torch.get(h.metrics.remote(), timeout=30.0)
                for h in engines.values()
            ]
            if all(
                s.get("queue_depth", 0) == 0
                and s.get("num_running", 0) == 0
                for s in stats
            ):
                break
            time.sleep(0.25)
        mid = {
            n: ray_tpu_torch.get(h.metrics.remote(), timeout=30.0)
            for n, h in engines.items()
        }
        flushed = sum(
            ray_tpu_torch.get(
                [h.flush_kv_fabric.remote() for h in engines.values()],
                timeout=60.0,
            )
        )

        # Per-session final prompts, in schedule order.
        finals = {}
        for r in requests:
            if r.scenario == "multiturn" and r.session_id is not None:
                finals[r.session_id] = list(r.prompt_ids)

        # Repeat wave through the router: the client-visible price of a
        # session resuming after its cache left the device tier.
        wave = []
        for prompt in finals.values():
            t0 = time.perf_counter()
            handle.remote(
                {"prompt_ids": prompt, "max_new_tokens": 2}
            ).result(timeout_s=60.0)
            wave.append(time.perf_counter() - t0)
        wave_p50 = sorted(wave)[len(wave) // 2] if wave else None

        # The deterministic cross-replica hit: one session's final
        # prompt served directly on each engine. Whichever engine did
        # not prefill that session's last turn is missing at least one
        # full block on device (a turn adds more than a block of
        # tokens), and after the flush the fabric holds it.
        probe = next(iter(finals.values()))
        for h in engines.values():
            ray_tpu_torch.get(h.generate.remote(probe, 2, None), timeout=60.0)
        after = {
            n: ray_tpu_torch.get(h.metrics.remote(), timeout=30.0)
            for n, h in engines.items()
        }
        cross_replica_hit_blocks = sum(
            after[n]["fabric_restore_blocks"]
            - mid[n]["fabric_restore_blocks"]
            for n in after
        )

        verdicts = {
            s.name: evaluate_slo(s, rep)
            for s in (LOOSE_SLO, IMPOSSIBLE_SLO)
        }
        store = next(iter(after.values()))["fabric_store"]
        return {
            "config": label,
            "knobs": {
                "kv_fabric": True,
                "affinity": affinity,
                "engine_per_replica": True,
                "num_replicas": 2,
            },
            "cpu_parity_only": False,
            **_served(device, model_config, base, spec),
            "rate": rate,
            "report": rep,
            "slo": verdicts,
            "fabric": {
                "flushed_blocks": flushed,
                "cross_replica_hit_blocks": cross_replica_hit_blocks,
                "repeat_wave_ttft_p50_s": wave_p50,
                "store": store,
                "per_engine": {
                    n: {
                        "fabric_spill_blocks": s["fabric_spill_blocks"],
                        "fabric_restore_blocks": s["fabric_restore_blocks"],
                        "fabric_hit_blocks": s["fabric_hit_blocks"],
                        "fabric_hit_rate": s["fabric_hit_rate"],
                        "fabric_timeouts": s["fabric_timeouts"],
                        "prefix_cache_hit_rate": s["prefix_cache_hit_rate"],
                    }
                    for n, s in after.items()
                },
            },
            "engine": {
                "wedged": any(s.get("wedged") for s in after.values()),
                "dead_letters": sum(
                    s.get("num_dead_letters", 0) for s in after.values()
                ),
            },
        }
    finally:
        _teardown(engine_name, per_replica=True, fabric_name=fabric_name)


def _gate_kv_fabric(cell: dict) -> List[str]:
    """Hard assertions for the fabric cells: zero dropped requests, the
    SLO gate pair still discriminates, no wedge, blocks actually demoted
    to the host tier, and at least one cross-replica fabric hit — a KV
    block prefilled by one replica served a request on the other."""
    tag = f"{cell['config']}@{cell['rate']}"
    problems = []
    if cell["report"]["num_errors"] != 0:
        problems.append(
            f"{tag}: {cell['report']['num_errors']} dropped requests "
            f"({cell['report']['errors']})"
        )
    if not cell["slo"]["loose"]["passed"]:
        problems.append(f"{tag}: loose SLO failed")
    if cell["slo"]["impossible"]["passed"]:
        problems.append(f"{tag}: impossible SLO passed")
    if cell["engine"].get("wedged"):
        problems.append(f"{tag}: engine wedged")
    fabric = cell["fabric"]
    if fabric["flushed_blocks"] <= 0:
        problems.append(f"{tag}: flush demoted no blocks to the fabric")
    if fabric["cross_replica_hit_blocks"] <= 0:
        problems.append(
            f"{tag}: no cross-replica fabric hit (restore delta "
            f"{fabric['cross_replica_hit_blocks']})"
        )
    return problems


def _await_drain_settled(
    app_name: str, timeout_s: float = 30.0
) -> dict:
    """Poll the controller until no replica is DRAINING, then return the
    deployment's lifecycle summary (state counts, drain totals, history
    tail) for the cell record."""
    import time as _time

    import ray_tpu_torch
    from ray_tpu_torch.serve._private.controller import get_or_create_controller

    controller = get_or_create_controller()
    deadline = _time.monotonic() + timeout_s
    dep: dict = {}
    while _time.monotonic() < deadline:
        obs = ray_tpu_torch.get(
            controller.get_observability.remote(), timeout=10.0
        )
        dep = obs.get(app_name, {}).get("LLMIngress", {})
        counts = dep.get("state_counts", {})
        if counts.get("DRAINING", 0) == 0 and dep.get(
            "num_drained_replicas", 0
        ) >= 1:
            break
        _time.sleep(0.1)
    return {
        "state_counts": dep.get("state_counts"),
        "num_drained_replicas": dep.get("num_drained_replicas"),
        "num_migrated_requests": dep.get("num_migrated_requests"),
        "history": dep.get("history", [])[-10:],
    }


def _gate_drain(cell: dict) -> List[str]:
    """Hard assertions for the drain cell: the scale event fired, zero
    requests dropped (every sample completed — multiturn has no poisons
    or disconnects), the SLO gate pair still discriminates, the KV +
    draft pools drained to boot size, and exactly one replica went
    through DRAINING → STOPPED leaving one RUNNING."""
    tag = f"{cell['config']}@{cell['rate']}"
    problems = []
    if cell["event"].get("error") or cell["event"].get("fired_s") is None:
        problems.append(f"{tag}: scale-down event failed: {cell['event']}")
    if cell["report"]["num_errors"] != 0:
        problems.append(
            f"{tag}: {cell['report']['num_errors']} dropped requests "
            f"under scale-down ({cell['report']['errors']})"
        )
    if not cell["slo"]["loose"]["passed"]:
        problems.append(f"{tag}: loose SLO failed")
    if cell["slo"]["impossible"]["passed"]:
        problems.append(f"{tag}: impossible SLO passed")
    if cell["engine"].get("kv_pool_allocated") not in (0, None):
        problems.append(
            f"{tag}: KV pool did not drain "
            f"(allocated={cell['engine']['kv_pool_allocated']})"
        )
    if cell["engine"].get("spec_draft_pool_allocated") not in (0, None):
        problems.append(f"{tag}: draft mirror pool did not drain")
    if cell["engine"].get("wedged"):
        problems.append(f"{tag}: engine wedged under scale-down")
    drain = cell.get("drain") or {}
    if drain.get("num_drained_replicas") != 1:
        problems.append(
            f"{tag}: expected exactly 1 drained replica, got "
            f"{drain.get('num_drained_replicas')}"
        )
    counts = drain.get("state_counts") or {}
    if counts.get("RUNNING") != 1 or counts.get("DRAINING", 0) != 0:
        problems.append(
            f"{tag}: post-drain replica states {counts} "
            "(want 1 RUNNING, 0 DRAINING)"
        )
    return problems


def _gate(cell: dict) -> List[str]:
    """The per-cell hard assertions every sweep run re-proves: the SLO
    gate must discriminate (loose passes, impossible fails), loadgen and
    engine percentiles must agree within one bucket, the engine must
    dead-letter exactly the poisons (dead letters == client-side
    PoisonRequestErrors, no wedge), and the KV/draft pools must drain
    back to boot size."""
    problems = []
    if not cell["slo"]["loose"]["passed"]:
        problems.append(f"{cell['config']}@{cell['rate']}: loose SLO failed")
    if cell["slo"]["impossible"]["passed"]:
        problems.append(
            f"{cell['config']}@{cell['rate']}: impossible SLO passed"
        )
    if not cell["cross_check"].get("agreed", False):
        problems.append(
            f"{cell['config']}@{cell['rate']}: loadgen/engine percentile "
            "cross-check disagreed by more than one bucket"
        )
    if cell["engine"].get("kv_pool_allocated") not in (0, None):
        problems.append(
            f"{cell['config']}@{cell['rate']}: KV pool did not drain "
            f"(allocated={cell['engine']['kv_pool_allocated']})"
        )
    if cell["engine"].get("spec_draft_pool_allocated") not in (0, None):
        problems.append(
            f"{cell['config']}@{cell['rate']}: draft mirror pool did not "
            "drain"
        )
    if cell["engine"].get("wedged"):
        problems.append(
            f"{cell['config']}@{cell['rate']}: engine wedged under load"
        )
    # Poison isolation: every dead letter must correspond to a client-side
    # PoisonRequestError — more dead letters means a non-poison request
    # was killed, fewer means a poison escaped the dead-letter path.
    dead = cell["engine"].get("dead_letters")
    poisons = cell["report"]["errors"].get("PoisonRequestError", 0)
    if dead is not None and dead != poisons:
        problems.append(
            f"{cell['config']}@{cell['rate']}: {dead} dead letters but "
            f"{poisons} client-side PoisonRequestErrors"
        )
    return problems


def _chosen_configs(
    configs: Optional[Sequence[str]], device: str
) -> Tuple[list, Optional[str]]:
    """The knob rows to run, and a note when the kernel row was left out:
    `configs=None` on the CPU runs every row but the kernel row; naming
    that row on the CPU raises (see _cell_device)."""
    chosen = [
        c
        for c in KNOB_CONFIGS
        if configs is None or c[0] in set(configs)
    ]
    if configs is not None and len(chosen) != len(set(configs)):
        known = [c[0] for c in KNOB_CONFIGS]
        raise ValueError(
            f"unknown config in {list(configs)}; choose from {known}"
        )
    for _label, overrides, _parity in chosen:
        if configs is not None:
            _cell_device(device, overrides)
    if configs is None and device == "cpu":
        chosen = [c for c in chosen if c[0] != KERNEL_ROW]
        return chosen, (
            f"The {KERNEL_ROW!r} row (the hand-written kernels by name) "
            "was left out: it runs only on the card."
        )
    return chosen, None


def run_sweep(
    rates: Sequence[float],
    num_requests: int,
    seed: int = 0,
    configs: Optional[Sequence[str]] = None,
    arrival_process: str = "poisson",
    record_name: str = "BENCH_SERVE",
    *,
    device="cuda",
    model_config=None,
    params=None,
    engine_base: Optional[dict] = None,
    scenario_overrides: Optional[dict] = None,
) -> Tuple[dict, List[str]]:
    """The full sweep: the chosen knob rows at every rate, then the drain
    cell, the collapse cell and the KV-fabric pair. Returns (record,
    gate_problems)."""
    import torch

    device = _cell_device(device)
    chosen, left_out = _chosen_configs(configs, device)
    served = dict(
        device=device,
        model_config=model_config,
        params=params,
        engine_base=engine_base,
        scenario_overrides=scenario_overrides,
    )
    cells = []
    problems: List[str] = []
    for label, overrides, parity in chosen:
        for rate in rates:
            cell = run_cell(
                label,
                overrides,
                parity,
                rate,
                num_requests,
                seed,
                arrival_process=arrival_process,
                **served,
            )
            cells.append(cell)
            cell_problems = _gate(cell)
            problems.extend(cell_problems)
            rep = cell["report"]
            p99 = rep["percentiles"]["ttft_s"].get("p99")
            print(
                f"[{record_name}] {label} @ {rate:g}/s: "
                f"achieved {rep['achieved_rate']:.2f}/s, "
                f"ttft_p99 {p99 if p99 is None else round(p99, 4)}s, "
                f"errors {rep['num_errors']}"
                + (f"  !! {cell_problems}" if cell_problems else "")
            )
    # The robustness cell: a chaos-gated scale-down under live traffic
    # rides every sweep (quick included), so a drain regression can never
    # ship behind a green perf record.
    drain_cell = run_drain_cell(
        rates[0], max(num_requests // 2, 12), seed, **served
    )
    cells.append(drain_cell)
    drain_problems = _gate_drain(drain_cell)
    problems.extend(drain_problems)
    print(
        f"[{record_name}] drain_scale_down @ {rates[0]:g}/s: "
        f"errors {drain_cell['report']['num_errors']}, "
        f"drained {drain_cell['drain'].get('num_drained_replicas')} "
        f"replica(s), migrated "
        f"{drain_cell['drain'].get('num_migrated_requests')} stream(s)"
        + (f"  !! {drain_problems}" if drain_problems else "")
    )
    # The overload-control cell: a ramp driven past saturation against
    # bounded admission rides every sweep (quick included), so a
    # queueing-collapse regression — unbounded backlog, slow or untyped
    # rejections, leaked pools — can never ship behind a green record.
    collapse_cell = run_collapse_cell(
        rates[0], max(num_requests, 24), seed, **served
    )
    cells.append(collapse_cell)
    collapse_problems = _gate_collapse(collapse_cell)
    problems.extend(collapse_problems)
    crep = collapse_cell["report"]
    print(
        f"[{record_name}] collapse_ramp @ {rates[0]:g}/s->"
        f"{collapse_cell['arrival'].get('ramp_to_rate', 0):g}/s: "
        f"completed {crep['completed']}, "
        f"shed {crep['num_shed']}, failures {crep['num_failures']}, "
        f"shed p99 "
        f"{(crep['shed_latency_s'].get('p99') or 0):.4f}s, "
        f"burn loose/impossible "
        f"{(collapse_cell['burn_rates'].get('loose') or 0):.2f}/"
        f"{(collapse_cell['burn_rates'].get('impossible') or 0):.1f}"
        + (f"  !! {collapse_problems}" if collapse_problems else "")
    )
    # The KV-fabric locality pair: multiturn over 2 per-replica engines
    # sharing one fabric, prefix-affinity routing on vs off — gated on
    # zero drops + at least one cross-replica fabric hit, on every sweep
    # (quick included).
    for affinity in (True, False):
        cell = run_kv_fabric_cell(
            affinity, rates[0], max(num_requests // 2, 12), seed, **served
        )
        cells.append(cell)
        cell_problems = _gate_kv_fabric(cell)
        problems.extend(cell_problems)
        fab = cell["fabric"]
        wave = fab["repeat_wave_ttft_p50_s"]
        print(
            f"[{record_name}] {cell['config']} @ {rates[0]:g}/s: "
            f"errors {cell['report']['num_errors']}, "
            f"cross-replica hits {fab['cross_replica_hit_blocks']} "
            f"blocks, flushed {fab['flushed_blocks']}, repeat p50 "
            f"{wave if wave is None else round(wave, 4)}s"
            + (f"  !! {cell_problems}" if cell_problems else "")
        )
    scenario = _build_scenario(
        num_requests,
        seed,
        model_config=model_config,
        engine_base=engine_base,
        scenario_overrides=scenario_overrides,
    )
    note = (
        "Open-loop driven through serve.build_app (router -> "
        "LLMIngress replica -> shared engine actor). The "
        "drain_scale_down cell fires a mid-run scale-down and gates "
        "on zero dropped requests + pools drained + exactly one "
        "replica DRAINING -> STOPPED. The kv_fabric_affinity / "
        "kv_fabric_p2c pair runs multiturn over two per-replica "
        "engines sharing one KV fabric (prefix-affinity routing on "
        "vs off), gated on zero drops + at least one cross-replica "
        "fabric hit. The collapse_ramp cell drives a "
        "ramp to 4x past saturation against bounded admission and gates "
        "on graceful degradation: accepted requests within SLO, "
        "rejections fast and typed (OverloadedError sheds, zero untyped "
        "failures), no wedge, pools back at boot size."
    )
    if left_out:
        note += " " + left_out
    record = {
        "record": record_name,
        "series": RECORD_SERIES,
        "backend": device,
        "device_name": (
            torch.cuda.get_device_name() if device.startswith("cuda")
            else "cpu"
        ),
        "note": note,
        "model": _model_summary(model_config or serve_model_config()),
        "engine_base": _engine_base(engine_base),
        "scenario": scenario.to_dict(),
        "rates": list(rates),
        "cells": cells,
        "gate_problems": problems,
    }
    return record, problems


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.loadgen.sweep",
        description="open-loop serving load generator / SLO gate / sweep",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser(
        "run", help="one scenario at one rate against one engine config"
    )
    p_run.add_argument(
        "--config",
        default="base",
        choices=[c[0] for c in KNOB_CONFIGS],
    )
    p_run.add_argument("--rate", type=float, default=4.0)
    p_run.add_argument(
        "--process",
        default="poisson",
        choices=("poisson", "uniform", "onoff", "ramp"),
    )
    p_run.add_argument("--num-requests", type=int, default=32)
    p_run.add_argument("--seed", type=int, default=0)
    p_run.add_argument("--json-out", default=None)
    p_run.add_argument(
        "--device", default="cuda",
        help="cuda (the default; raises without CUDA) or cpu",
    )

    p_sweep = sub.add_parser(
        "sweep", help="knob-space sweep emitting a serving record"
    )
    p_sweep.add_argument(
        "--quick",
        action="store_true",
        help="short cut: base and async_step, one rate, small n — still "
        "asserts the loose/impossible SLO gate pair and the engine "
        "cross-check",
    )
    p_sweep.add_argument("--rates", default=None, help="comma-separated")
    p_sweep.add_argument("--num-requests", type=int, default=None)
    p_sweep.add_argument("--seed", type=int, default=0)
    p_sweep.add_argument(
        "--configs", default=None, help="comma-separated config labels"
    )
    p_sweep.add_argument("--record-name", default="BENCH_SERVE")
    p_sweep.add_argument(
        "--out", required=True, help="record JSON path (no default)"
    )
    p_sweep.add_argument(
        "--device", default="cuda",
        help="cuda (the default; raises without CUDA) or cpu",
    )

    p_rep = sub.add_parser(
        "report", help="summarize an existing serving record"
    )
    p_rep.add_argument("path")

    args = parser.parse_args(list(argv) if argv is not None else None)

    if args.cmd == "report":
        from ray_tpu_torch.loadgen.report import format_report

        with open(args.path) as f:
            record = json.load(f)
        for cell in record.get("cells", []):
            parity = " [cpu-parity-only]" if cell.get("cpu_parity_only") else ""
            print(f"== {cell['config']} @ {cell['rate']:g}/s{parity}")
            print(
                format_report(
                    cell["report"], list(cell.get("slo", {}).values())
                )
            )
        if record.get("gate_problems"):
            print("gate problems:", record["gate_problems"])
            return 1
        return 0

    import ray_tpu_torch

    # Refuse the device before anything starts.
    device = _cell_device(args.device)
    ray_tpu_torch.init(num_cpus=8, ignore_reinit_error=True)
    try:
        if args.cmd == "run":
            cfg = next(c for c in KNOB_CONFIGS if c[0] == args.config)
            cell = run_cell(
                cfg[0],
                cfg[1],
                cfg[2],
                args.rate,
                args.num_requests,
                args.seed,
                arrival_process=args.process,
                device=device,
            )
            from ray_tpu_torch.loadgen.report import format_report

            print(
                format_report(
                    cell["report"], list(cell["slo"].values())
                )
            )
            if args.json_out:
                with open(args.json_out, "w") as f:
                    json.dump(cell, f, indent=2)
            problems = _gate(cell)
            if problems:
                print("GATE FAILURES:")
                for p in problems:
                    print(f"  {p}")
                return 1
            return 0

        if args.quick:
            rates = [6.0]
            num_requests = args.num_requests or 24
            # async_step rides the quick gate so the double-buffered loop
            # stays SLO-clean under live traffic, not just in unit tests.
            configs = (
                args.configs.split(",")
                if args.configs
                else ["base", "async_step"]
            )
        else:
            rates = [4.0, 12.0]
            num_requests = args.num_requests or 48
            configs = args.configs.split(",") if args.configs else None
        if args.rates:
            rates = [float(r) for r in args.rates.split(",")]
        record, problems = run_sweep(
            rates,
            num_requests,
            seed=args.seed,
            configs=configs,
            record_name=args.record_name,
            device=device,
        )
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2)
        print(f"wrote {args.out} ({len(record['cells'])} cells)")
        if problems:
            print("GATE FAILURES:")
            for p in problems:
                print(f"  {p}")
            return 1
        return 0
    finally:
        ray_tpu_torch.shutdown()


if __name__ == "__main__":
    sys.exit(main())
