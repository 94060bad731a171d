"""Open-loop arrival processes: when each request fires, decided up front.

Open-loop is the point: arrival times are drawn from the process BEFORE
the run and the driver fires each request at its scheduled time whether
or not earlier responses have come back. A closed-loop client (send,
wait, send) self-throttles exactly when the server saturates, so
queueing collapse never shows up in its latency numbers — the open-loop
schedule keeps offered load constant and lets the queue (and the
percentiles) explode where they really would.

All processes are seeded (`random.Random(seed)`) and draw nothing from
wall clock or global RNG state: same spec ⇒ byte-identical schedule.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List

PROCESSES = ("poisson", "uniform", "onoff", "ramp")


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """Declarative arrival process.

      * ``poisson`` — exponential inter-arrivals at `rate`/s (memoryless;
        the canonical open-loop workload).
      * ``uniform`` — fixed 1/rate spacing (deterministic; useful for
        tests and capacity probing).
      * ``onoff`` — bursty diurnal phases: Poisson at `rate` for `on_s`
        seconds, then at `rate * off_rate_fraction` for `off_s` seconds,
        repeating. Exponential memorylessness makes clamp-at-boundary +
        redraw exact, so phase edges are respected.
      * ``ramp`` — a rate sweep: arrival i draws its gap at the rate
        linearly interpolated from `rate` to `ramp_to_rate` across the
        run (walks the load axis in one schedule).
    """

    process: str = "poisson"
    rate: float = 4.0  # mean arrivals per second (start rate for ramp)
    seed: int = 0
    on_s: float = 2.0
    off_s: float = 2.0
    off_rate_fraction: float = 0.0
    ramp_to_rate: float = 16.0

    def __post_init__(self):
        if self.process not in PROCESSES:
            raise ValueError(
                f"unknown arrival process {self.process!r}; choose from "
                f"{PROCESSES}"
            )
        if self.rate <= 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")
        if self.process == "onoff":
            if self.on_s <= 0 or self.off_s < 0:
                raise ValueError("onoff needs on_s > 0 and off_s >= 0")
            if self.off_rate_fraction < 0:
                raise ValueError("off_rate_fraction must be >= 0")
        if self.process == "ramp" and self.ramp_to_rate <= 0:
            raise ValueError("ramp_to_rate must be > 0")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def arrival_times(spec: ArrivalSpec, n: int) -> List[float]:
    """`n` arrival offsets in seconds from run start, non-decreasing."""
    if n <= 0:
        return []
    rng = random.Random((spec.seed, spec.process).__repr__())
    if spec.process == "uniform":
        gap = 1.0 / spec.rate
        return [i * gap for i in range(n)]
    if spec.process == "poisson":
        out, t = [], 0.0
        for _ in range(n):
            t += rng.expovariate(spec.rate)
            out.append(t)
        return out
    if spec.process == "ramp":
        out, t = [], 0.0
        for i in range(n):
            frac = i / max(n - 1, 1)
            r = spec.rate + frac * (spec.ramp_to_rate - spec.rate)
            t += rng.expovariate(r)
            out.append(t)
        return out
    # onoff: piecewise-constant rate; an exponential gap that would cross
    # a phase boundary is discarded and redrawn from the boundary at the
    # new phase's rate — exact for Poisson processes (memorylessness).
    period = spec.on_s + spec.off_s
    out: List[float] = []
    t = 0.0
    while len(out) < n:
        phase_t = t % period
        in_on = phase_t < spec.on_s
        r = spec.rate if in_on else spec.rate * spec.off_rate_fraction
        boundary = t - phase_t + (spec.on_s if in_on else period)
        if r <= 0.0:
            t = boundary
            continue
        gap = rng.expovariate(r)
        if t + gap > boundary:
            t = boundary
            continue
        t += gap
        out.append(t)
    return out
