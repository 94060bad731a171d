"""The port's loadgen (pure parts) against the reference's, exactly.

Scenarios, arrival processes, SLO specs, reports and the report CLI are
pure, seeded Python: the same inputs through `ray_tpu.loadgen` and
`ray_tpu_torch.loadgen` must give equal values, equal errors and equal
text. The open-loop driver runs against a handle-shaped stub on both.
"""

import dataclasses
import json

import pytest

from ray_tpu import loadgen as jax_lg
from ray_tpu.llm.serve import llm_stream_resume as jax_resume
from ray_tpu.loadgen import driver as jax_driver
from ray_tpu.loadgen import report as jax_report
from ray_tpu.loadgen import sweep as jax_sweep
from ray_tpu_torch import loadgen as port_lg
from ray_tpu_torch.llm.serve import llm_stream_resume as port_resume
from ray_tpu_torch.loadgen import driver as port_driver
from ray_tpu_torch.loadgen import report as port_report
from ray_tpu_torch.loadgen import sweep as port_sweep

PKGS = {"ray_tpu": jax_lg, "ray_tpu_torch": port_lg}
DRIVERS = {"ray_tpu": jax_driver, "ray_tpu_torch": port_driver}
REPORTS = {"ray_tpu": jax_report, "ray_tpu_torch": port_report}


def _both(fn):
    """fn(package) on each package: (reference's value, port's value)."""
    return fn(jax_lg), fn(port_lg)


def _outcome(fn, lg):
    """fn(lg)'s value, or its error's type name and message."""
    try:
        return ("ok", fn(lg))
    except Exception as exc:  # noqa: BLE001 - the error is the datum
        return (type(exc).__name__, str(exc))


# ---------------- scenarios ----------------


@pytest.mark.parametrize("seed", [0, 7, 11])
@pytest.mark.parametrize("name", jax_lg.SCENARIOS)
def test_generate_requests_match_reference(name, seed):
    def gen(lg):
        spec = lg.ScenarioSpec.for_engine(64, 64, 128, name=name,
                                          num_requests=24, seed=seed)
        return lg.generate_requests(spec)

    ref, port = _both(gen)
    assert len(port) == 24
    assert [dataclasses.asdict(r) for r in port] == [dataclasses.asdict(r) for r in ref]
    assert port_lg.schedule_fingerprint(port) == jax_lg.schedule_fingerprint(ref)
    assert port_lg.schedule_fingerprint(port) == jax_lg.schedule_fingerprint(port)


def test_scenario_for_engine_and_to_dict_match_reference():
    """for_engine's admission caps on the card's engine geometry (block 16,
    64 blocks a sequence) and GPT-2's vocab, with overrides."""
    def spec(lg):
        return lg.ScenarioSpec.for_engine(
            1024, 1024, 50304, name="mixed", num_requests=24, seed=0,
            max_new_tokens=32, prompt_len_median=128.0, output_len_median=24.0,
            shared_prefix_len=64, turn_tokens=32).to_dict()

    ref, port = _both(spec)
    assert port == ref
    assert port["max_prompt_len"] == 1024 - 32


SCENARIO_ERRORS = [
    lambda lg: lg.ScenarioSpec(max_new_tokens=3),
    lambda lg: lg.ScenarioSpec(vocab_size=2),
    lambda lg: lg.ScenarioSpec(max_prompt_len=3),
    lambda lg: lg.ScenarioSpec.for_engine(8, 8, 128, max_new_tokens=8),
    lambda lg: lg.generate_requests(lg.ScenarioSpec(name="nope")),
    lambda lg: lg.generate_requests(lg.ScenarioSpec(mix=(("nope", 1.0),))),
    lambda lg: lg.generate_requests(lg.ScenarioSpec(mix=(("poison", 0.0),))),
]


@pytest.mark.parametrize("case", range(len(SCENARIO_ERRORS)))
def test_scenario_validation_matches_reference(case):
    ref = _outcome(SCENARIO_ERRORS[case], jax_lg)
    port = _outcome(SCENARIO_ERRORS[case], port_lg)
    assert ref[0] == "ValueError"
    assert port == ref


# ---------------- arrivals ----------------


@pytest.mark.parametrize("process", jax_lg.PROCESSES)
def test_arrival_times_match_reference(process):
    def times(lg):
        spec = lg.ArrivalSpec(process=process, rate=6.0, seed=5,
                              off_rate_fraction=0.2, ramp_to_rate=400.0)
        return lg.arrival_times(spec, 64), spec.to_dict()

    ref, port = _both(times)
    assert port == ref  # equal floats, not close ones
    assert port[0] == sorted(port[0])


ARRIVAL_ERRORS = [
    dict(process="burst"),
    dict(rate=0.0),
    dict(process="onoff", on_s=0.0),
    dict(process="onoff", off_rate_fraction=-1.0),
    dict(process="ramp", ramp_to_rate=0.0),
]


@pytest.mark.parametrize("kwargs", ARRIVAL_ERRORS)
def test_arrival_spec_validation_matches_reference(kwargs):
    ref = _outcome(lambda lg: lg.ArrivalSpec(**kwargs), jax_lg)
    port = _outcome(lambda lg: lg.ArrivalSpec(**kwargs), port_lg)
    assert ref[0] == "ValueError"
    assert port == ref


# ---------------- SLO specs ----------------


SLO_CASES = [
    dict(ttft_p99=0.5, tpot_p50=0.01, error_rate=0.05),
    dict(e2e_p100=60.0),
    dict(ttft_p99_9=1.0),
    dict(queue_p99=1.0),
    dict(ttft_p99=0.0),
    dict(tpot_p0=1.0),
]


@pytest.mark.parametrize("bounds", SLO_CASES)
def test_slo_spec_parsing_matches_reference(bounds):
    def parse(lg):
        spec = lg.SLOSpec.from_bounds("svc", **dict(bounds))
        return spec.to_dict(), [dataclasses.asdict(r) for r in spec.rules]

    assert _outcome(parse, port_lg) == _outcome(parse, jax_lg)


def test_gate_pair_matches_reference():
    for name in ("LOOSE_SLO", "IMPOSSIBLE_SLO"):
        assert getattr(port_lg, name).to_dict() == getattr(jax_lg, name).to_dict()


# ---------------- reports and verdicts ----------------


def _fake_result(driver, n_ok=20, n_err=2, sheds=(), ttft=0.01, tpot=0.002):
    samples = []
    for i in range(n_ok):
        samples.append(driver.RequestSample(
            request_id=f"ok-{i}", kind="normal", scenario="longtail",
            session_id=None, scheduled_s=i * 0.1, sent_s=i * 0.1 + 0.001 * i,
            ttft_s=ttft * (1 + i), tpot_s=tpot, e2e_s=ttft + 10 * tpot,
            num_tokens=10))
    for i in range(n_err):
        samples.append(driver.RequestSample(
            request_id=f"bad-{i}", kind="poison", scenario="poison",
            session_id=None, scheduled_s=i * 0.1, sent_s=i * 0.1,
            error="PoisonRequestError"))
    for i, (cls, lat) in enumerate(sheds):
        samples.append(driver.RequestSample(
            request_id=f"shed-{i}", kind="normal", scenario="longtail",
            session_id=None, scheduled_s=1.0, sent_s=1.0, error=cls,
            error_latency_s=lat))
    samples.append(driver.RequestSample(
        request_id="gone", kind="disconnect", scenario="disconnect",
        session_id=None, scheduled_s=0.5, sent_s=0.5, ttft_s=0.02, num_tokens=2,
        disconnected=True))
    return driver.LoadRunResult(
        samples=samples, offered_duration_s=n_ok * 0.1,
        wall_duration_s=n_ok * 0.1 + 0.05,
        offered_rate=(len(samples)) / max(n_ok * 0.1, 1e-9))


SHEDS = (("TaskError(EngineOverloadedError)", 0.002), ("EngineOverloadedError", 0.004),
         ("FleetOverloadedError", 0.006))
REPORT_CASES = {
    "poisons": dict(),
    "sheds": dict(n_ok=10, n_err=1, sheds=SHEDS),
    "empty": dict(n_ok=0, n_err=0),
}


@pytest.mark.parametrize("case", sorted(REPORT_CASES))
def test_build_report_evaluate_slo_format_report_match_reference(case):
    """Sheds split from failures; errors never latency samples; a run with
    no samples fails an SLO rather than passing it."""
    out = {}
    for name, lg in PKGS.items():
        result = _fake_result(DRIVERS[name], **REPORT_CASES[case])
        rep = lg.build_report(result)
        tight = lg.SLOSpec.from_bounds("lat", ttft_p99=1.0, tpot_p50=0.01,
                                       error_rate=0.1)
        verdicts = [lg.evaluate_slo(s, rep) for s in (lg.LOOSE_SLO, lg.IMPOSSIBLE_SLO, tight)]
        out[name] = (rep, verdicts, lg.format_report(rep, verdicts),
                     result.to_dict(), result.achieved_rate)
    assert out["ray_tpu_torch"] == out["ray_tpu"]
    rep, verdicts = out["ray_tpu_torch"][:2]
    if case == "sheds":
        assert rep["num_shed"] == 3 and rep["num_failures"] == 1
    if case == "empty":
        assert verdicts[0]["passed"] is False  # no samples cannot pass


def test_percentile_and_shed_classes_match_reference():
    samples = [0.3, 0.1, 0.2, 0.5, 0.4, 0.05]
    for q in (0.0, 37.5, 50.0, 90.0, 99.0, 99.9, 100.0):
        assert port_report.percentile(samples, q) == jax_report.percentile(samples, q)
        assert port_report.pct_key(q) == jax_report.pct_key(q)
    assert port_report.percentile([], 50.0) is None
    with pytest.raises(ValueError):
        port_report.percentile(samples, 101.0)
    for cls in ("EngineOverloadedError", "TaskError(EngineOverloadedError)",
                "FleetOverloadedError", "PoisonRequestError", None):
        assert port_report.is_shed_error(cls) == jax_report.is_shed_error(cls)
    # The port's typed shed is recognised by name.
    from ray_tpu_torch.exceptions import EngineOverloadedError, FleetOverloadedError

    assert port_report.is_shed_error(EngineOverloadedError.__name__)
    assert port_report.is_shed_error(FleetOverloadedError.__name__)


def _window(boundaries, buckets):
    return {"boundaries": list(boundaries), "buckets": list(buckets),
            "sum": 0.0, "count": sum(buckets)}


def test_engine_percentiles_and_cross_check_match_reference():
    """The before/after histogram diff and the one-bucket agreement rule,
    on the engine's decade ladder: one metric agreeing, one off by two
    buckets, one missing."""
    bounds = [0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0]
    before = {"ttft_s": _window(bounds, [0, 1, 2, 0, 0, 0, 0, 0, 0]),
              "tpot_s": None, "e2e_s": None, "queue_s": None}
    after = {"ttft_s": _window(bounds, [0, 3, 9, 4, 1, 0, 0, 0, 0]),
             "tpot_s": _window(bounds, [0, 0, 0, 0, 0, 6, 2, 0, 0]),
             "e2e_s": None, "queue_s": _window(bounds, [5, 0, 0, 0, 0, 0, 0, 0, 0])}
    rep = {"percentiles": {"ttft_s": {"p50": 0.009, "p99": 0.06},
                           "tpot_s": {"p50": 0.004, "p99": 0.009}}}
    got = {}
    for name, mod in REPORTS.items():
        pcts = mod.engine_percentiles(before, after)
        got[name] = (pcts, mod.cross_check(rep, pcts, after))
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    assert got["ray_tpu_torch"][1]["agreed"] is False


# ---------------- the report CLI ----------------


def test_report_cli_round_trip_matches_reference(tmp_path, capsys):
    record = {
        "record": "serving-test",
        "cells": [{
            "config": "base", "rate": 4.0, "cpu_parity_only": False,
            "report": jax_lg.build_report(_fake_result(jax_driver)),
            "slo": {"loose": jax_lg.evaluate_slo(
                jax_lg.LOOSE_SLO, jax_lg.build_report(_fake_result(jax_driver)))},
        }],
        "gate_problems": [],
    }
    path = tmp_path / "rec.json"
    path.write_text(json.dumps(record))
    printed = {}
    for name, mod in (("ray_tpu", jax_sweep), ("ray_tpu_torch", port_sweep)):
        assert mod.main(["report", str(path)]) == 0
        printed[name] = capsys.readouterr().out
    assert printed["ray_tpu_torch"] == printed["ray_tpu"]
    assert "base @ 4/s" in printed["ray_tpu_torch"]
    assert "SLO loose: PASS" in printed["ray_tpu_torch"]
    record["gate_problems"] = ["x"]
    path.write_text(json.dumps(record))
    assert port_sweep.main(["report", str(path)]) == jax_sweep.main(["report", str(path)]) == 1


# ---------------- the driver on a stub handle ----------------


class _StubStreamHandle:
    """Handle-shaped stub: every request streams three fixed token dicts."""

    def __init__(self):
        self.resume_fns = []
        self.requests = []

    def options(self, **opts):
        self.resume_fns.append(opts.get("stream_resume_fn"))
        return self

    def remote(self, request):
        self.requests.append(request)
        return iter({"token_id": t} for t in (7, 8, 9))


def _stub_run(lg, resume_fn, record_tokens):
    spec = lg.ScenarioSpec(name="repetitive", num_requests=3, seed=0, max_new_tokens=4)
    requests = lg.generate_requests(spec)
    fired = []

    def boom():
        raise RuntimeError("chaos hook failed")

    events = [lg.ScheduledEvent(offset_s=0.01, name="ok", fn=lambda: fired.append(1)),
              lg.ScheduledEvent(offset_s=0.03, name="boom", fn=boom)]
    handle = _StubStreamHandle()
    result = lg.run_open_loop(handle, requests, [0.0, 0.02, 0.04], timeout_s=5.0,
                              settle_timeout_s=10.0, events=events,
                              stream_resume_fn=resume_fn, record_tokens=record_tokens)
    return {
        "fired": fired,
        "events": [(e["name"], e["fired_s"] is not None, e["error"], e["cancelled"])
                   for e in result.to_dict()["events"]],
        "resume_fns": [f is resume_fn for f in handle.resume_fns],
        "requests": handle.requests,
        "samples": [(s.request_id, s.token_ids, s.num_tokens, s.error,
                     s.disconnected, s.ttft_s is not None, s.tpot_s is not None,
                     s.e2e_s is not None) for s in result.samples],
        "completed": len(result.completed),
    }


@pytest.mark.parametrize("record_tokens", [True, False])
def test_run_open_loop_on_a_stub_handle_matches_reference(record_tokens):
    """Scheduled events fire with their outcome recorded (an event's
    exception is data), the resume fn reaches every dispatch, and
    record_tokens captures the delivered ids — the same on both."""
    ref = _stub_run(jax_lg, jax_resume, record_tokens)
    port = _stub_run(port_lg, port_resume, record_tokens)
    assert port == ref
    assert port["fired"] == [1]
    assert port["events"][1][2] is not None and "chaos hook failed" in port["events"][1][2]
    assert port["resume_fns"] == [True] * 3
    if record_tokens:
        assert all(s[1] == [7, 8, 9] for s in port["samples"])


def test_open_loop_rejects_mismatched_schedules_and_arms_poisons():
    def run(lg):
        spec = lg.ScenarioSpec.for_engine(64, 64, 128, name="poison", num_requests=3)
        reqs = lg.generate_requests(spec)
        try:
            lg.run_open_loop(_StubStreamHandle(), reqs, [0.0])
        except ValueError as exc:
            err = str(exc)
        armed = lg.arm_poison_faults(reqs)
        out = (err, [(f.site, f.match, f.nth, f.message) for f in armed])
        return out, armed

    (ref, ref_specs), (port, port_specs) = _both(run)
    try:
        assert port == ref
        assert len(port[1]) == 3 and port[1][0][0] == port_driver.POISON_SITE
    finally:
        from ray_tpu._private import fault_injection as jax_fi
        from ray_tpu_torch._private import fault_injection as port_fi

        for spec in ref_specs:
            jax_fi.remove(spec)
        for spec in port_specs:
            port_fi.remove(spec)
