"""Declarative SLO specs and the pass/fail gate over a load report.

An `SLOSpec` is a set of percentile bounds on the serving SLO metrics
(TTFT / TPOT / e2e, seconds) plus an optional error-rate bound. The gate
evaluates a report built by `ray_tpu_torch.loadgen.report.build_report` and
returns a verdict with one check per rule — machine-readable (the
sweep's record embeds it) and assertable (every sweep cell runs a
deliberately-loose and a deliberately-impossible spec through the same
run and asserts pass/fail respectively, so the gate machinery itself is
exercised end-to-end every time).

Errors (dead-lettered poison requests, timeouts) count toward
`error_rate` and are never latency samples; mid-stream disconnects are a
separate population (their TTFT is real, their e2e is not — see
report.build_report).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

from ray_tpu_torch.loadgen.report import pct_key

SLO_METRICS = ("ttft", "tpot", "e2e")

_RULE_KEY = re.compile(r"^(ttft|tpot|e2e)_p(100|\d{1,2}(?:\.\d+)?)$")


@dataclasses.dataclass(frozen=True)
class SLORule:
    """One bound: `metric`'s `percentile` must be < `max_seconds`."""

    metric: str
    percentile: float
    max_seconds: float

    def __post_init__(self):
        if self.metric not in SLO_METRICS:
            raise ValueError(
                f"SLO metric must be one of {SLO_METRICS}, got "
                f"{self.metric!r}"
            )
        if not 0.0 < self.percentile <= 100.0:
            raise ValueError(
                f"percentile must be in (0, 100], got {self.percentile}"
            )
        if self.max_seconds <= 0:
            raise ValueError(
                f"max_seconds must be > 0, got {self.max_seconds}"
            )

    @property
    def label(self) -> str:
        return f"{self.metric}_{pct_key(self.percentile)}"


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """A named bundle of rules, e.g.::

        SLOSpec.from_bounds("interactive",
                            ttft_p99=0.5, tpot_p99=0.05, error_rate=0.01)
    """

    name: str
    rules: Tuple[SLORule, ...] = ()
    max_error_rate: Optional[float] = None

    @classmethod
    def from_bounds(cls, name: str, **bounds: float) -> "SLOSpec":
        """Build from `<metric>_p<q>=seconds` keys plus an optional
        `error_rate=fraction` bound."""
        max_error_rate = bounds.pop("error_rate", None)
        rules = []
        for key, limit in sorted(bounds.items()):
            m = _RULE_KEY.match(key)
            if m is None:
                raise ValueError(
                    f"unknown SLO bound {key!r} (expected e.g. ttft_p99, "
                    "tpot_p50, e2e_p99, error_rate)"
                )
            rules.append(
                SLORule(
                    metric=m.group(1),
                    percentile=float(m.group(2)),
                    max_seconds=float(limit),
                )
            )
        return cls(
            name=name, rules=tuple(rules), max_error_rate=max_error_rate
        )

    def to_dict(self) -> dict:
        out = {r.label: r.max_seconds for r in self.rules}
        if self.max_error_rate is not None:
            out["error_rate"] = self.max_error_rate
        return {"name": self.name, "bounds": out}


def evaluate_slo(spec: SLOSpec, report: dict) -> dict:
    """Gate `report` (report.build_report output) against `spec`.

    A rule whose percentile has no samples FAILS with observed=None — a
    run that produced nothing cannot demonstrate an SLO was met. Returns
    {"slo", "passed", "checks": [{rule, limit, observed, passed}, ...]}.
    """
    checks = []
    pcts = report.get("percentiles", {})
    for rule in spec.rules:
        metric_pcts = pcts.get(f"{rule.metric}_s", {})
        key = pct_key(rule.percentile)
        observed = metric_pcts.get(key)
        check = {
            "rule": rule.label,
            "limit_s": rule.max_seconds,
            "observed_s": observed,
            "passed": observed is not None and observed < rule.max_seconds,
        }
        if observed is None:
            # Distinguish "the run produced no samples" from "the report
            # never computed this percentile" (build_report computes a
            # fixed set — pass extra qs there to gate on others): both
            # fail, but only one is the server's fault.
            check["reason"] = (
                "no samples"
                if key in metric_pcts
                else f"percentile {key} not computed in the report "
                f"(available: {sorted(metric_pcts)})"
            )
        checks.append(check)
    if spec.max_error_rate is not None:
        observed_rate = report.get("error_rate")
        checks.append(
            {
                "rule": "error_rate",
                "limit": spec.max_error_rate,
                "observed": observed_rate,
                "passed": observed_rate is not None
                and observed_rate <= spec.max_error_rate,
            }
        )
    return {
        "slo": spec.name,
        "passed": all(c["passed"] for c in checks),
        "checks": checks,
    }


# The pair every sweep cell asserts with: a bound no healthy run (the
# tiny model on the CPU, or GPT-2 on the card) can miss, and one no
# physical system can meet.
LOOSE_SLO = SLOSpec.from_bounds(
    "loose", ttft_p99=30.0, tpot_p99=10.0, e2e_p99=60.0, error_rate=0.9
)
IMPOSSIBLE_SLO = SLOSpec.from_bounds(
    "impossible", ttft_p99=1e-9, tpot_p99=1e-9, error_rate=0.0
)
