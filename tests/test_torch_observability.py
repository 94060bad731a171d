"""The port's fleet observability plane against the reference's.

The pure parts (histogram merging, the time ledger, the burn-rate monitor
over an injected source, the Perfetto renderer) take the same inputs in
both packages and must give equal values. The live parts run on the
port's serve path on the CPU: a real flight ring's ledger covers its
wall, `fleet_snapshot` merges two engines' histograms and ledgers, and
one request's `timeline(trace_id=...)` is a loadable Chrome trace with
handle, replica and engine rows stitched by flow events. Every program
that waits on a serve app runs under a time limit.
"""

import json
import threading

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu import observability as jax_obs
from ray_tpu.loadgen import slo as jax_slo
from ray_tpu.observability import perfetto as jax_perfetto
from ray_tpu.serve import config as jax_serve_config
from ray_tpu.util import metrics as jax_metrics
from ray_tpu_torch import observability as port_obs
from ray_tpu_torch import serve
from ray_tpu_torch._private.runtime import get_runtime
from ray_tpu_torch.llm import EngineConfig, LLMServer
from ray_tpu_torch.llm.serve import build_app
from ray_tpu_torch.loadgen import slo as port_slo
from ray_tpu_torch.models import GPTConfig
from ray_tpu_torch.observability import perfetto as port_perfetto
from ray_tpu_torch.observability.ledger import REPLICA_COLUMNS
from ray_tpu_torch.serve import config as port_serve_config
from ray_tpu_torch.util import metrics as port_metrics
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.runtime_metrics import list_llm_engine_actors

torch.set_num_threads(1)

LIMIT_S = 45.0
TINY = GPTConfig(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64,
                 max_seq_len=128, dtype=torch.float32, attention_impl="reference")
ECFG = EngineConfig(block_size=4, num_blocks=24, max_decode_slots=4,
                    max_blocks_per_seq=8, prefill_buckets=(8, 32))
METRICS = {"ray_tpu": jax_metrics, "ray_tpu_torch": port_metrics}
OBS = {"ray_tpu": jax_obs, "ray_tpu_torch": port_obs}


def _within(limit_s, fn, *args):
    out = {}

    def run():
        try:
            out["value"] = fn(*args)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            out["error"] = exc

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(limit_s)
    assert not t.is_alive(), f"{getattr(fn, '__name__', fn)} ran past {limit_s}s"
    if "error" in out:
        raise out["error"]
    return out["value"]


def _outcome(fn, *args, **kwargs):
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as exc:  # noqa: BLE001 - the error is the datum
        return (type(exc).__name__, str(exc))


def _snap(boundaries, buckets, total=None, count=None):
    return {"boundaries": list(boundaries), "buckets": list(buckets),
            "sum": sum(buckets) if total is None else total,
            "count": sum(buckets) if count is None else count}


# ---------------- util.metrics additions ----------------


MERGES = {
    "sum": [_snap([1.0, 2.0], [1, 2, 3], 4.0, 6), _snap([1.0, 2.0], [0, 1, 1], 2.5, 2)],
    "single": [_snap([1.0, 2.0], [1, 2, 3])],
    "ladders": [_snap([1.0, 2.0], [1, 2, 3]), _snap([1.0, 5.0], [1, 2, 3])],
    "lengths": [_snap([1.0, 2.0], [1, 2, 3]), _snap([1.0, 2.0], [1, 2])],
    "empty": [],
}


@pytest.mark.parametrize("case", sorted(MERGES))
def test_merge_snapshots_matches_reference(case):
    got = {name: _outcome(m.merge_snapshots, MERGES[case]) for name, m in METRICS.items()}
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    if case in ("ladders", "lengths"):
        assert got["ray_tpu_torch"][0] == "BucketMismatchError"
        with pytest.raises(ValueError):  # a BucketMismatchError is a ValueError
            port_metrics.merge_snapshots(MERGES[case])
        assert issubclass(port_metrics.BucketMismatchError, ValueError)


def test_fraction_over_threshold_and_bucket_index_match_reference():
    bounds = [1.0, 2.0, 4.0]
    for buckets in ([2, 2, 2, 2], [0, 0, 0, 0], [5, 0, 1, 0], [1, 2]):
        for threshold in (0.5, 1.0, 2.0, 3.0, 100.0):
            got = {n: _outcome(m.fraction_over_threshold, bounds, buckets, threshold)
                   for n, m in METRICS.items()}
            assert got["ray_tpu_torch"] == got["ray_tpu"]
    for value in (0.0, 1.0, 1.5, 4.0, 9.0):
        assert port_metrics.bucket_index(bounds, value) == jax_metrics.bucket_index(
            bounds, value)


def test_histogram_snapshot_and_percentile_match_reference():
    """The registry readers on one series of a registered histogram, the
    same observations in each package's registry."""
    values = [0.002, 0.004, 0.03, 0.2, 0.07, 0.9, 3.0, 0.0005]
    got = {}
    for name, m in METRICS.items():
        h = m.get_or_create(m.Histogram, "torch_obs_test_seconds", "test",
                            tag_keys=("engine",))
        before = m.histogram_snapshot("torch_obs_test_seconds", {"engine": "e1"})
        for v in values:
            h.observe(v, tags={"engine": "e1"})
        after = m.histogram_snapshot("torch_obs_test_seconds", {"engine": "e1"})
        pcts = [m.histogram_percentile("torch_obs_test_seconds", q, {"engine": "e1"})
                for q in (50.0, 99.0)]
        missing = _outcome(m.histogram_snapshot, "torch_obs_no_such_metric")
        got[name] = (before["count"], after["buckets"], after["count"],
                     round(after["sum"], 12), pcts, missing[0])
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    assert got["ray_tpu_torch"][5] == "KeyError"


# ---------------- the time ledger ----------------


T0 = 1000.0
STEP_RECORDS = {
    "full": {"time": T0, "duration_s": 0.100, "dispatch_time": T0 + 0.030,
             "ready_time": T0 + 0.080, "prefill_s": 0.012, "fabric_wait_s": 0.003,
             "commits": [{"tokens": 4, "commit_s": 0.010}], "host_gap_s": 0.002},
    "idle": {"time": 5.0, "duration_s": 0.05, "commits": []},
    "overrun": {"time": 10.0, "duration_s": 0.010, "dispatch_time": 10.002,
                "ready_time": 10.5, "prefill_s": 0.004,
                "commits": [{"tokens": 1, "commit_s": 0.2}]},
    "port_shape": {"time": T0, "duration_s": 0.02, "dispatch_time": T0 + 0.004,
                   "ready_time": T0 + 0.015, "prefill_s": 0.001,
                   "commits": [{"tokens": 3, "commit_s": 0.001}], "host_gap_s": None},
}


@pytest.mark.parametrize("case", sorted(STEP_RECORDS))
def test_step_ledger_matches_reference(case):
    rec = STEP_RECORDS[case]
    got = port_obs.step_ledger(rec)
    assert got == jax_obs.step_ledger(rec)
    cols = port_obs.LEDGER_COLUMNS
    assert sum(got[c] for c in cols) == pytest.approx(got["duration_s"])
    assert all(got[c] >= 0.0 for c in cols)


def _steps(n, start, gap, tokens):
    out = []
    for i in range(n):
        t = start + i * gap
        out.append({"time": t, "duration_s": 0.1, "dispatch_time": t + 0.01,
                    "ready_time": t + 0.08, "prefill_s": 0.0,
                    "commits": [{"tokens": tokens, "commit_s": 0.01}],
                    "host_gap_s": 0.001 * i})
    return out


@pytest.mark.parametrize("peak", [None, 1e6])
def test_replica_and_fleet_ledger_match_reference(peak):
    replicas = {"r0": _steps(2, 100.0, 0.2, 4), "r1": _steps(3, 101.0, 0.15, 6),
                "idle": []}
    got = {}
    for name, obs in OBS.items():
        ledgers = {r: obs.replica_ledger(s, model_params=1000, peak_flops_per_s=peak)
                   for r, s in replicas.items()}
        got[name] = (ledgers, obs.fleet_ledger(ledgers),
                     obs.mfu_estimate(124_000_000, 500.0, 989e12))
    assert got["ray_tpu_torch"] == got["ray_tpu"]
    ledgers, fleet, mfu = got["ray_tpu_torch"]
    assert ledgers["r0"]["coverage"] == pytest.approx(1.0)
    assert set(fleet["columns"]) == set(REPLICA_COLUMNS)
    assert mfu == pytest.approx(2 * 124e6 * 500 / 989e12)


def test_peak_flops_comes_from_the_environment(monkeypatch):
    for raw, want in (("989e12", 989e12), ("bad", None), ("-1", None), ("", None)):
        monkeypatch.setenv("RAY_TPU_PEAK_FLOPS", raw)
        assert port_obs.ledger.default_peak_flops_per_s() == want
        assert jax_obs.ledger.default_peak_flops_per_s() == want


def test_a_real_flight_ring_covers_its_wall():
    """The port's engine on the CPU: the ledger of its flight record sums
    to 100% +- 5% of the span it covers, and counts every committed
    token."""
    server = LLMServer(TINY, ECFG, device="cpu")
    try:
        rng = np.random.RandomState(3)
        prompts = [list(map(int, rng.randint(1, 128, size=n))) for n in (5, 9, 14, 7)]
        threads = [threading.Thread(target=server.generate, args=(p,),
                                    kwargs={"max_new_tokens": 6}, daemon=True)
                   for p in prompts]
        for t in threads:
            t.start()
        for t in threads:
            t.join(LIMIT_S)
        assert not any(t.is_alive() for t in threads)
        steps = server.flight_record()["steps"]
        stats = server.metrics()
    finally:
        server.shutdown()
    ledger = port_obs.replica_ledger(steps, model_params=stats["model_params"],
                                     peak_flops_per_s=989e12)
    assert ledger["steps"] == len(steps) > 0
    assert 0.95 <= ledger["coverage"] <= 1.05, ledger
    assert ledger["columns"]["fabric_wait_s"] == 0.0  # the fabric is off here
    assert 0 < ledger["committed_tokens"] <= len(prompts) * 6
    assert ledger["mfu"] > 0


# ---------------- the burn-rate monitor ----------------


_BOUNDS = [0.001, 0.01, 0.1, 1.0, 10.0]


def _ttft(good, bad):
    return {"boundaries": list(_BOUNDS), "buckets": [0, 0, good, 0, bad, 0],
            "sum": 0.05 * good + 5.0 * bad, "count": good + bad}


SERIES = [(0.0, _ttft(0, 0)), (2.0, _ttft(10, 90)), (4.0, _ttft(40, 90)),
          (10.0, _ttft(110, 90)), (70.0, _ttft(200, 95))]


def _burn_run(slo_mod, obs, windows):
    spec = slo_mod.SLOSpec.from_bounds("torch-burn", ttft_p99=1.0, e2e_p99=2.0)
    state = {}
    mon = obs.SLOBurnRateMonitor(spec, windows=windows,
                                 source=lambda: {"llm_request_ttft_seconds": state["cur"]})
    out = []
    for now, snap in SERIES:
        state["cur"] = dict(snap)
        out.append((mon.sample(now=now), mon.burn_rates(), mon.autoscaler_signal(),
                    mon.peak_burn()))
    return out, [mon.peak_burn(w) for w in windows], mon.windows


@pytest.mark.parametrize("windows", [(5.0,), (5.0, 60.0)])
def test_burn_rates_match_reference_and_recover(windows):
    ref = _burn_run(jax_slo, jax_obs, windows)
    port = _burn_run(port_slo, port_obs, windows)
    assert port == ref
    rows = port[0]
    assert rows[0][0]["5s"] == 0.0  # no traffic burns nothing
    assert rows[1][0]["5s"] > 1.0  # the burst burns
    assert rows[3][0]["5s"] < 1.0  # and the short window recovers
    assert port[1][0] == pytest.approx(rows[1][0]["5s"])  # the peak remembers
    text = port_metrics.prometheus_text()
    assert 'llm_slo_burn_rate{slo="torch-burn",window="5s"}' in text


def test_burn_rate_feeds_the_autoscaling_policy():
    """The monitor's signal drives LLMAutoscalingPolicy's burn target to the
    same decisions as the reference's (up when hot, hold within the
    margin, down when cold); the policy refuses a missing or bad target."""
    decisions = {}
    for name, (slo_mod, obs, cfg) in {
        "ray_tpu": (jax_slo, jax_obs, jax_serve_config),
        "ray_tpu_torch": (port_slo, port_obs, port_serve_config),
    }.items():
        policy = cfg.LLMAutoscalingPolicy(min_replicas=1, max_replicas=3,
                                          target_burn_rate=1.0)
        state = {}
        mon = obs.SLOBurnRateMonitor(
            slo_mod.SLOSpec.from_bounds("torch-policy", ttft_p99=1.0), windows=(5.0,),
            source=lambda: {"llm_request_ttft_seconds": state["cur"]}, gauge=False)
        out = []
        for (now, snap), current in zip(SERIES[:4], (1, 2, 2, 2)):
            state["cur"] = dict(snap)
            mon.sample(now=now)
            signals = dict(mon.autoscaler_signal(), window_complete=True)
            out.append((signals["slo_burn_rate"],
                        policy.desired_replicas(signals, current=current)))
        out.append([_outcome(cfg.LLMAutoscalingPolicy, **kw) for kw in (
            dict(min_replicas=1, max_replicas=2),
            dict(min_replicas=1, max_replicas=2, target_burn_rate=-1.0))])
        decisions[name] = out
    assert decisions["ray_tpu_torch"] == decisions["ray_tpu"]
    assert decisions["ray_tpu_torch"][1][1] == 3  # hot: scale up
    assert decisions["ray_tpu_torch"][3][1] == 1  # cold: scale down
    assert all(o[0] == "ValueError" for o in decisions["ray_tpu_torch"][4])


def test_burn_monitor_reads_the_registry_and_runs_in_the_background():
    h = port_metrics.get_or_create(
        port_metrics.Histogram, "llm_request_ttft_seconds",
        "Time to first token", tag_keys=("engine",))
    mon = port_obs.SLOBurnRateMonitor(port_slo.IMPOSSIBLE_SLO, windows=(5.0,),
                                      gauge=False)
    mon.sample()
    h.observe(0.5, tags={"engine": "torch-obs-burn"})
    assert mon.sample()["5s"] > 1.0
    assert mon.start(interval_s=0.01) is mon.start(interval_s=0.01)
    mon.stop()
    assert mon._thread is None


# ---------------- the Perfetto renderer ----------------


SPANS = [
    {"trace_id": "t", "span_id": "a", "parent_span_id": None, "name": "serve.handle.request",
     "start_s": 1.0, "end_s": 2.0, "kind": "user", "attributes": {}},
    {"trace_id": "t", "span_id": "b", "parent_span_id": "a",
     "name": "ReplicaActor.handle_request_streaming", "start_s": 1.1, "end_s": 1.9,
     "kind": "task", "attributes": {"state": "FINISHED"}},
    {"trace_id": "t", "span_id": "c", "parent_span_id": "b", "name": "serve.replica.stream",
     "start_s": 1.15, "end_s": 1.85, "kind": "user", "attributes": {"replica": "r#0"}},
    {"trace_id": "t", "span_id": "d", "parent_span_id": "c", "name": "llm.request",
     "start_s": 1.2, "end_s": 1.8, "kind": "user", "attributes": {"request_id": "x"}},
    {"trace_id": "t", "span_id": "e", "parent_span_id": "d", "name": "llm.prefill",
     "start_s": 1.21, "end_s": 1.3, "kind": "user", "attributes": {"bucket": 8}},
    {"trace_id": "t", "span_id": "f", "parent_span_id": "d", "name": "llm.decode",
     "start_s": 1.3, "end_s": 1.8, "kind": "user", "attributes": {}},
    {"trace_id": "t", "span_id": "g", "parent_span_id": "a", "name": "serve.retry",
     "start_s": 1.05, "end_s": None, "kind": "user", "attributes": {}},
    {"trace_id": "t", "span_id": "h", "parent_span_id": "b", "name": "LLMServer.generate_stream",
     "start_s": 1.2, "end_s": 1.8, "kind": "task", "attributes": {}},
    {"trace_id": "t", "span_id": "i", "parent_span_id": "a", "name": "train.step",
     "start_s": 1.4, "end_s": 1.5, "kind": "user", "attributes": {}},
]


def test_perfetto_trace_matches_reference(monkeypatch):
    for mod in (jax_perfetto, port_perfetto):
        monkeypatch.setattr(mod.tracing, "traces",
                            lambda trace_id=None, runtime=None: [dict(s) for s in SPANS])
    ref = jax_perfetto.perfetto_trace(trace_id="t")
    port = port_perfetto.perfetto_trace(trace_id="t")
    assert port == ref
    rows = {e["args"]["name"] for e in port["traceEvents"]
            if e["ph"] == "M" and e["name"] == "process_name"}
    assert {"serve.handle", "serve.replica", "llm.engine", "train"} <= rows
    assert any(e["ph"] == "s" for e in port["traceEvents"])


# ---------------- the fleet on the serve path ----------------


@pytest.fixture(scope="module")
def fleet():
    """Two ingress replicas, each with its own engine (engine_per_replica),
    a concurrent wave of requests, and one request under a client span."""
    def start():
        ray_tpu_torch.init(num_cpus=8, num_gpus=0)
        handle = serve.run(build_app(TINY, ECFG, engine_name="torchfleet", num_replicas=2,
                                     engine_per_replica=True, device="cpu"),
                           name="torchfleet")
        rng = np.random.RandomState(19)
        prompts = [list(map(int, rng.randint(0, 128, size=n)))
                   for n in rng.randint(4, 12, size=14)]
        refs = [handle.remote({"prompt_ids": p, "max_new_tokens": 6}) for p in prompts]
        tokens = [len(r.result(timeout_s=60)["token_ids"]) for r in refs]
        with tracing.span("client") as client:
            with tracing.span("serve.handle.request"):
                res = handle.remote({"prompt_ids": prompts[0], "max_new_tokens": 4})
                traced = len(res.result(timeout_s=60)["token_ids"])
        return {"handle": handle, "prompts": prompts, "tokens": tokens,
                "traced": traced, "trace_id": client.trace_id}

    state = _within(LIMIT_S, start)
    yield state
    serve.shutdown()
    ray_tpu_torch.shutdown()


def test_fleet_snapshot_merges_both_engines(fleet):
    assert fleet["tokens"] == [6] * len(fleet["prompts"]) and fleet["traced"] == 4
    snap = _within(LIMIT_S, port_obs.fleet_snapshot, None, 512, 5.0, 989e12)
    replicas = snap["replicas"]
    assert len(replicas) == 2, sorted(replicas)
    names = sorted(n for n, _ in list_llm_engine_actors(get_runtime()))
    assert sorted(replicas) == names
    active = 0
    for name, row in replicas.items():
        assert "error" not in row, (name, row)
        ledger = row["ledger"]
        assert set(ledger["columns"]) == set(REPLICA_COLUMNS)
        assert row["model_params"] and row["model_params"] > 0
        if ledger["steps"]:
            active += 1
            assert 0.95 <= ledger["coverage"] <= 1.05, (name, ledger)
            assert ledger["mfu"] > 0
    assert active >= 1
    fleet_ledger = snap["fleet"]
    assert fleet_ledger["replicas"] == 2
    assert fleet_ledger["committed_tokens"] > 0
    assert 0.95 <= fleet_ledger["min_coverage"] <= 1.05
    # Merged request histograms carry every request exactly once.
    ttft = snap["histograms"]["llm_request_ttft_seconds"]
    assert ttft["count"] == len(fleet["prompts"]) + 1
    assert snap["percentiles"]["llm_request_ttft_seconds"]["p99"] > 0
    json.dumps(snap)  # host values only, nothing that holds a tensor


def test_fleet_collector_keeps_the_latest_snapshot(fleet):
    collector = port_obs.FleetCollector(get_runtime(), period_s=0.05)
    try:
        latest = _within(LIMIT_S, lambda: _poll(collector.latest))
    finally:
        collector.stop()
    assert len(latest["replicas"]) == 2
    assert collector.latest(max_age_s=3600.0) is not None


def _poll(read, timeout_s=20.0):
    import time

    deadline = time.monotonic() + timeout_s
    value = read()
    while value is None and time.monotonic() < deadline:
        time.sleep(0.02)
        value = read()
    return value


def test_timeline_exports_one_request_with_flow_events(fleet, tmp_path):
    out = tmp_path / "request_timeline.json"
    trace = ray_tpu_torch.timeline(str(out), trace_id=fleet["trace_id"])
    loaded = json.loads(out.read_text())  # valid Chrome-trace JSON
    assert loaded["traceEvents"] == trace["traceEvents"]
    assert trace == ray_tpu_torch.timeline(trace_id=fleet["trace_id"])
    events = loaded["traceEvents"]
    rows = {e["args"]["name"]: e["pid"] for e in events
            if e["ph"] == "M" and e["name"] == "process_name"}
    assert {"serve.handle", "serve.replica", "llm.engine", "driver"} <= set(rows), rows
    llm_names = {e["name"] for e in events
                 if e["ph"] == "X" and e["pid"] == rows["llm.engine"]}
    assert "llm.request" in llm_names
    assert all(e["args"]["trace_id"] == fleet["trace_id"]
               for e in events if e["ph"] == "X")
    starts = [e for e in events if e["ph"] == "s"]
    finishes = {e["id"]: e for e in events if e["ph"] == "f"}
    assert starts and finishes
    crossed = 0
    for s in starts:
        f = finishes.get(s["id"])
        assert f is not None, f"unpaired flow {s['id']}"
        crossed += f["pid"] != s["pid"]
    assert crossed > 0
    # Without trace_id the timeline is the task/span array it always was.
    assert isinstance(ray_tpu_torch.timeline(), list)
