"""The port's sweep cells beyond the knob rows, and its entry points.

The drain cell on the port passes `_gate_drain` (zero drops, one replica
DRAINING -> STOPPED, pools at boot size). The collapse cell runs on both
packages at the same seed and the port must do at least as well as the
reference on every clause of `_gate_collapse`, and pass every clause but
one outright: typed sheds only, the burn pair (loose < 1 < impossible),
the accepted requests within their SLO, no wedge, pools at boot size.
The clause left to the comparison is "rejections fast" (shed p99 under
the accepted TTFT p50). On the CPU both packages miss it: a shed crosses
the same two actor hops as an accepted request's first token, under the
burst's load, while the accepted median is set by the calm start of the
ramp. The card run (chip_smoke.py) holds the whole gate.

Then the entry points: the sweep's cells default to the card and raise
without CUDA, the kernel row refuses the CPU naming the card, and
`main(["run", ...])` on the CPU writes its cell. The KV-fabric pair is held
in tests/test_torch_kvfabric_serve.py.
"""

import json
import threading
import time

import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.loadgen import sweep as jax_sweep
from ray_tpu_torch._private.runtime import get_runtime
from ray_tpu_torch.loadgen import report as port_report
from ray_tpu_torch.loadgen import sweep as port_sweep
from ray_tpu_torch.util.runtime_metrics import list_llm_engine_actors

torch.set_num_threads(1)

LIMIT_S = 50.0


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


def _in_runtime(rt, fn, *args, **kwargs):
    def program():
        rt.init(num_cpus=8, num_gpus=0)
        try:
            return fn(*args, **kwargs)
        finally:
            rt.shutdown()

    return _within(LIMIT_S, program)


def _engine_loops() -> set:
    """The engine loop threads alive now. A cell's leak is a loop it
    started that is still alive after it: a loop of an earlier test that
    ends meanwhile is none of its doing."""
    return {t for t in threading.enumerate() if t.name == "llm-engine-loop" and t.is_alive()}


def _port_cell(fn, *args, **kwargs):
    """A port cell in its own runtime; also what it left behind: live
    engine actors, and engine loop threads still running (ROADMAP §D8: a
    cell ends its app, then its engine's loop, then the engine)."""
    def program():
        ray_tpu_torch.init(num_cpus=8, num_gpus=0)
        loops = _engine_loops()
        try:
            cell = fn(*args, **kwargs)
            return cell, list_llm_engine_actors(get_runtime()), len(_engine_loops() - loops)
        finally:
            ray_tpu_torch.shutdown()

    return _within(LIMIT_S, program)


def test_drain_cell_passes_its_gate():
    cell, engines, loops = _port_cell(port_sweep.run_drain_cell, 6.0, 12, 0, device="cpu")
    assert engines == [] and loops == 0, (engines, loops)
    assert port_sweep._gate_drain(cell) == [], cell["drain"]
    assert cell["drain"]["num_drained_replicas"] == 1
    states = [h["state"] for h in cell["drain"]["history"]]
    assert "DRAINING" in states and states[-1] == "STOPPED"
    assert cell["report"]["completed"] == cell["report"]["requests"] == 12
    assert cell["engine_base"] == jax_sweep.BASE_ENGINE
    ref_spec = ray_tpu.loadgen.ScenarioSpec.for_engine(
        64, 64, vocab_size=128, name="multiturn", num_requests=12, seed=0)
    assert cell["scenario"] == ref_spec.to_dict()


# Each clause of _gate_collapse, by a phrase of its message.
COLLAPSE_CLAUSES = {
    "shed nothing": "shed_nothing", "untyped failures": "untyped",
    "broke the SLO": "accepted_slo", "impossible SLO passed": "impossible_passed",
    "never exceeded 1.0": "impossible_burn", "loose-SLO burn": "loose_burn",
    "rejections not fast": "shed_speed", "wedged": "wedged",
    "KV pool did not drain": "kv_pool", "draft mirror": "draft_pool",
    "no sheds": "engine_sheds",
}


def _clauses(problems):
    out = set()
    for p in problems:
        keys = [k for phrase, k in COLLAPSE_CLAUSES.items() if phrase in p]
        assert len(keys) == 1, p
        out |= set(keys)
    return out


@pytest.fixture(scope="module")
def collapse_cells():
    return {
        "ray_tpu": _in_runtime(ray_tpu, jax_sweep.run_collapse_cell, 6.0, 24, 0),
        "ray_tpu_torch": _port_cell(port_sweep.run_collapse_cell, 6.0, 24, 0,
                                    device="cpu"),
    }


def test_collapse_cell_does_as_well_as_the_reference(collapse_cells):
    ref, (port, engines, loops) = collapse_cells["ray_tpu"], collapse_cells["ray_tpu_torch"]
    assert engines == [] and loops == 0, (engines, loops)
    ref_clauses = _clauses(jax_sweep._gate_collapse(ref))
    port_clauses = _clauses(port_sweep._gate_collapse(port))
    shed = (port["report"]["shed_latency_s"]["p99"],
            port["report"]["percentiles"]["ttft_s"]["p50"])
    assert port_clauses <= {"shed_speed"}, (port_clauses, shed)
    assert port_clauses <= ref_clauses, (port_clauses, ref_clauses, shed)


def test_collapse_cell_sheds_typed_and_burns(collapse_cells):
    port = collapse_cells["ray_tpu_torch"][0]
    rep = port["report"]
    assert rep["num_shed"] > 0 and rep["num_failures"] == 0
    assert all(port_report.is_shed_error(e) for e in rep["errors"]), rep["errors"]
    assert port["burn_rates"]["loose"] < 1.0 < port["burn_rates"]["impossible"]
    assert port["engine"]["shed_requests"] > 0
    assert port["engine"]["max_queue_len"] == jax_sweep.BASE_ENGINE["max_decode_slots"]
    assert port["engine"]["kv_pool_allocated"] == 0
    assert rep["requests"] == 64
    # A shed still costs less than the accepted tail's first token.
    assert rep["shed_latency_s"]["p99"] < rep["percentiles"]["ttft_s"]["p99"]
    assert port["knobs"] == collapse_cells["ray_tpu"]["knobs"]


def test_a_shed_does_not_wait_for_a_stream_to_end():
    """ROADMAP §D9. Every live stream holds one of the engine actor's
    threads. With the card's engine (16 decode slots, 16 queued) the
    reference's pool of 32 is full once admission is, so the request that
    must be shed waited in the actor's inbox until a stream ended (the
    collapse cell's shed p99 ~0.5 s on the card). The port sizes the pool
    past the live streams: with 32 streams live and decoding slowly, one
    more request is shed at once, and the engine still answers metrics."""
    from ray_tpu_torch import serve
    from ray_tpu_torch._private import fault_injection as fi
    from ray_tpu_torch.exceptions import FleetOverloadedError
    from ray_tpu_torch.llm import EngineConfig
    from ray_tpu_torch.llm.serve import build_app, engine_concurrency

    ecfg = EngineConfig(block_size=8, num_blocks=256, max_decode_slots=16,
                        max_blocks_per_seq=8, max_queue_len=16)
    assert engine_concurrency(ecfg) > 16 + 16

    def program():
        ray_tpu_torch.init(num_cpus=8, num_gpus=0)
        gens = []
        delay = None
        try:
            handle = serve.run(build_app(port_sweep.serve_model_config(), ecfg,
                                         engine_name="shed-threads",
                                         max_concurrent_queries=64, device="cpu"),
                               name="shedthreads")
            handle.remote({"prompt_ids": [1, 2, 3], "max_new_tokens": 2}).result(timeout_s=60)
            metrics = handle.options(method_name="metrics")
            # ~0.16 s a decode step with 16 slots: a 56-token stream lives
            # ~9 s, far longer than this program needs.
            delay = fi.inject("llm.decode.seq", action="delay", delay_s=0.01, every=1,
                              times=None)
            live = 0
            for i in range(32):
                gens.append(handle.options(stream=True).remote(
                    {"prompt_ids": [1 + i, 2, 3], "max_new_tokens": 56, "stream": True}))
                live = _wait_live(metrics, i + 1)
            t0 = time.perf_counter()
            try:
                handle.remote({"prompt_ids": [7, 7, 7], "max_new_tokens": 4}).result(
                    timeout_s=30)
                shed = None
            except FleetOverloadedError as exc:
                shed = exc
            latency = time.perf_counter() - t0
            after = metrics.remote().result(timeout_s=10)
            return live, shed, latency, after
        finally:
            if delay is not None:
                fi.remove(delay)
            for gen in gens:
                gen.cancel()
            serve.shutdown()
            ray_tpu_torch.shutdown()

    live, shed, latency, after = _within(LIMIT_S, program)
    assert live == 32
    assert shed is not None, "the 33rd request was admitted: admission never bound"
    assert latency < 2.0, latency  # not a stream's lifetime
    assert after["num_running"] == 16 and after["shed_requests"] >= 1


def _wait_live(metrics, n, timeout_s=15.0):
    deadline = time.monotonic() + timeout_s
    live = 0
    while time.monotonic() < deadline:
        m = metrics.remote().result(timeout_s=10)
        live = m["num_running"] + m["queue_depth"]
        if live >= n:
            break
        time.sleep(0.01)
    return live


def test_kernel_row_refuses_the_cpu_naming_the_card():
    label, overrides, parity = next(c for c in port_sweep.KNOB_CONFIGS if c[0] == "cuda")
    assert overrides == {"attn_impl": "cuda"} and parity is False
    with pytest.raises(ValueError, match="H100"):
        port_sweep.run_cell(label, overrides, parity, 6.0, 8, 0, device="cpu")
    with pytest.raises(ValueError, match="card"):
        port_sweep.run_sweep([6.0], 8, configs=["base", "cuda"], device="cpu")
    chosen, note = port_sweep._chosen_configs(None, "cpu")
    assert [c[0] for c in chosen] == [c[0] for c in port_sweep.KNOB_CONFIGS
                                      if c[0] != "cuda"]
    assert "left out" in note
    assert port_sweep._chosen_configs(None, "cuda") == (list(port_sweep.KNOB_CONFIGS), None)
    with pytest.raises(ValueError, match="unknown config"):
        port_sweep._chosen_configs(["pallas_interpret"], "cpu")



ENTRY_POINTS = {
    "run_cell": lambda: port_sweep.run_cell("base", {}, False, 6.0, 8, 0),
    "run_drain_cell": lambda: port_sweep.run_drain_cell(6.0, 12, 0),
    "run_collapse_cell": lambda: port_sweep.run_collapse_cell(6.0, 24, 0),
    "run_kv_fabric_cell": lambda: port_sweep.run_kv_fabric_cell(True, 6.0, 12, 0),
    "run_sweep": lambda: port_sweep.run_sweep([6.0], 8),
    "main run": lambda: port_sweep.main(["run", "--num-requests", "8"]),
    "main sweep": lambda: port_sweep.main(["sweep", "--quick", "--out", "unused.json"]),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(entry):
    """Without device= (or --device) every entry point raises before it
    starts anything: no runtime, no app."""
    if torch.cuda.is_available():
        pytest.skip("holds the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[entry]()
    from ray_tpu_torch._private import runtime as port_runtime

    assert port_runtime._RUNTIME is None


CROSS_CHECK_FAILURE = "cross-check disagreed"
# As the reference's own smoke test retries once: the cross-check exists
# to catch a systematic disagreement (a broken clock or sample
# population), which every run reproduces. On the CPU the tiny model's
# engine TTFT p50 is ~2.5-7 ms and the client's carries ~5 ms of actor
# hops, so a p50 on a bucket edge can straddle two buckets by just over
# the 5 ms allowance on a loaded box (8 samples: p99 is the slowest one).
CROSS_CHECK_ATTEMPTS = 3


def test_main_run_on_the_cpu_writes_its_cell(tmp_path, capsys):
    out = tmp_path / "cell.json"
    argv = ["run", "--config", "base", "--num-requests", "8", "--device", "cpu",
            "--json-out", str(out)]
    for _attempt in range(CROSS_CHECK_ATTEMPTS):
        rc = _within(LIMIT_S, port_sweep.main, argv)
        printed = capsys.readouterr().out
        failures = [line for line in printed.split("GATE FAILURES:")[-1].splitlines()
                    if line.strip()] if rc else []
        if not (failures and all(CROSS_CHECK_FAILURE in f for f in failures)):
            break
    assert rc == 0, (printed, json.loads(out.read_text())["cross_check"])
    cell = json.loads(out.read_text())
    assert cell["config"] == "base" and cell["device"] == "cpu"
    assert cell["report"]["requests"] == 8
    assert "SLO loose: PASS" in printed
    assert "SLO impossible: FAIL" in printed
