"""ray_tpu_torch.loadgen — open-loop traffic harness with SLO gating.

The proving ground for the serving stack: seeded workload scenarios
(`scenarios`), open-loop arrival processes (`arrivals`), a driver that
fires requests at their scheduled times against the real
proxy→replica→engine path and never waits for responses (`driver`),
declarative SLO specs + pass/fail gate (`slo`), report building with a
cross-check against the engine's own `llm_request_*` histograms
(`report`), and the knob-space sweep that gates every serving knob
under load and returns its record (`sweep`).

The spec dataclasses (`ScenarioSpec`, `ArrivalSpec`, `SLOSpec`) are the
reusable interface: future chaos and autoscaling work drives the same
harness with different specs.
"""

from ray_tpu_torch.loadgen.arrivals import PROCESSES, ArrivalSpec, arrival_times
from ray_tpu_torch.loadgen.driver import (
    LoadRunResult,
    RequestSample,
    ScheduledEvent,
    arm_poison_faults,
    run_open_loop,
)
from ray_tpu_torch.loadgen.report import (
    build_report,
    cross_check,
    engine_percentiles,
    engine_window,
    format_report,
    percentile,
)
from ray_tpu_torch.loadgen.scenarios import (
    SCENARIOS,
    LoadRequest,
    ScenarioSpec,
    generate_requests,
    schedule_fingerprint,
)
from ray_tpu_torch.loadgen.slo import (
    IMPOSSIBLE_SLO,
    LOOSE_SLO,
    SLORule,
    SLOSpec,
    evaluate_slo,
)

__all__ = [
    "ArrivalSpec",
    "IMPOSSIBLE_SLO",
    "LOOSE_SLO",
    "LoadRequest",
    "LoadRunResult",
    "PROCESSES",
    "RequestSample",
    "SCENARIOS",
    "SLORule",
    "SLOSpec",
    "ScenarioSpec",
    "ScheduledEvent",
    "arm_poison_faults",
    "arrival_times",
    "build_report",
    "cross_check",
    "engine_percentiles",
    "engine_window",
    "evaluate_slo",
    "format_report",
    "generate_requests",
    "percentile",
    "run_open_loop",
    "schedule_fingerprint",
]
