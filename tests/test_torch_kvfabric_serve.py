"""The port's KV fabric behind Serve and in the sweep, on the CPU.

Prefix-affinity routing is declared on the deployment exactly when the
fabric asks for it; two per-replica engines on one fabric route a repeat
session to the replica holding its cache, and a drained replica's cache
survives through the fabric (the reference's chaos acceptance, with the
tokens held against ray_tpu.llm's engine on the same weights). The sweep's
`kv_fabric_affinity` / `kv_fabric_p2c` pair passes `_gate_kv_fabric` on
the port as on the reference, leaves no engine and no store behind, and
`run_sweep` runs and gates the pair after the collapse cell.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

import ray_tpu
import ray_tpu_torch
from ray_tpu.llm import EngineConfig as JaxEngineConfig
from ray_tpu.llm import LLMEngine as JaxLLMEngine
from ray_tpu.loadgen import sweep as jax_sweep
from ray_tpu.models.gpt import GPT as JaxGPT
from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_tpu_torch import serve
from ray_tpu_torch.llm import EngineConfig, KVFabricConfig
from ray_tpu_torch.llm.kvfabric import LLMPrefixAffinity
from ray_tpu_torch.llm.serve import build_app
from ray_tpu_torch.loadgen import sweep as port_sweep
from ray_tpu_torch.models import GPTConfig, params_from_flax

torch.set_num_threads(1)

TINY = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64, max_seq_len=128)
JAX_TINY = JaxGPTConfig(**TINY, dtype=jnp.float32, attention_impl="reference")
PORT_TINY = GPTConfig(**TINY, dtype=torch.float32, attention_impl="reference")
ECFG = dict(block_size=4, num_blocks=12, max_decode_slots=4, max_blocks_per_seq=8,
            prefill_buckets=(8, 32))
LIMIT_S = 60.0
RATE, NUM_REQUESTS, SEED = 6.0, 12, 0


@pytest.fixture(scope="module")
def weights():
    params = JaxGPT(JAX_TINY).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, meta.unbox(params))
    return tree, params_from_flax(tree)


@pytest.fixture
def port_runtime():
    ray_tpu_torch.init(num_cpus=8)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


def _live(prefix):
    return sorted(port_sweep._live_actors(prefix))


def _prompts(lengths, seed):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(1, 128, size=n))) for n in lengths]


@pytest.mark.parametrize("affinity", [True, False])
def test_affinity_is_declared_on_the_deployment_when_asked(affinity):
    ecfg = EngineConfig(**ECFG, kv_fabric=KVFabricConfig(affinity=affinity))
    app = build_app(PORT_TINY, ecfg, device="cpu")
    declared = app.deployment._config.affinity_key_fn
    assert declared == (LLMPrefixAffinity(ECFG["block_size"]) if affinity else None)
    assert build_app(PORT_TINY, EngineConfig(**ECFG), device="cpu").deployment._config.affinity_key_fn is None


def test_affinity_routing_and_drain_preserve_the_cache(weights, port_runtime):
    """Two ingress replicas, each with its own engine on one fabric.
    Affinity lands a repeat session on the replica holding its KV (device
    prefix hits on turn 2); scaling to one replica drains the other, whose
    shutdown flushes its cache into the fabric; every session repeated
    after the drain is served token-identically, with fabric restores on
    the survivor."""
    tree, state = weights
    oracle = JaxLLMEngine(JAX_TINY, JaxEngineConfig(**ECFG), params=tree)
    cfg = EngineConfig(**ECFG, kv_fabric=KVFabricConfig(name="serve-drain",
                                                        byte_budget=8 << 20))
    handle = serve.run(
        build_app(PORT_TINY, cfg, params=state, engine_name="fabdrain", num_replicas=2,
                  engine_per_replica=True, graceful_shutdown_timeout_s=5.0, device="cpu"),
        name="fabdrain",
    )
    prompts = _prompts((10, 10, 10, 10), seed=10)
    want = oracle.generate(prompts, max_new_tokens=6)

    def ask(p):
        return handle.remote({"prompt_ids": p, "max_new_tokens": 6}).result(
            timeout_s=LIMIT_S)["token_ids"]

    for _turn in range(2):
        assert [ask(p) for p in prompts] == want
    engines = port_sweep._live_actors("llm_engine:fabdrain-")
    assert len(engines) == 2
    stats = [ray_tpu_torch.get(h.metrics.remote(), timeout=LIMIT_S) for h in engines.values()]
    assert sum(s["prefix_cache_hit_tokens"] for s in stats) > 0

    serve.scale_deployment("LLMIngress", 1, app_name="fabdrain")
    deadline = time.monotonic() + LIMIT_S
    while time.monotonic() < deadline and len(_live("llm_engine:fabdrain-")) != 1:
        time.sleep(0.1)
    (survivor,) = _live("llm_engine:fabdrain-")
    assert [ask(p) for p in prompts] == want
    stats = ray_tpu_torch.get(ray_tpu_torch.get_actor(survivor).metrics.remote(),
                              timeout=LIMIT_S)
    assert stats["fabric_restore_blocks"] > 0, "the drained sessions re-prefilled"
    assert stats["fabric_store"]["bytes_used"] > 0 and stats["fabric_timeouts"] == 0


def _jax_live(prefix):
    from ray_tpu._private.runtime import get_runtime

    return sorted(rec.name for rec in get_runtime().controller.list_actors()
                  if getattr(rec, "name", None) and rec.name.startswith(prefix)
                  and rec.state.value == "ALIVE")


@pytest.fixture(scope="module")
def fabric_cells():
    """Both packages' fabric pair at the sweep's quick size, each in its
    own runtime, with the stores each package's cells left alive and the
    engines the port's left."""
    cells = {}
    ray_tpu.init(num_cpus=8)
    try:
        cells["ray_tpu"] = {a: jax_sweep.run_kv_fabric_cell(a, RATE, NUM_REQUESTS, SEED)
                            for a in (True, False)}
        ref_stores = _jax_live("kv_fabric:")
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.init(num_cpus=8)
    try:
        cells["ray_tpu_torch"] = {
            a: port_sweep.run_kv_fabric_cell(a, RATE, NUM_REQUESTS, SEED, device="cpu")
            for a in (True, False)}
        left = {"engines": _live("llm_engine:"), "stores": _live("kv_fabric:"),
                "reference stores": ref_stores}
    finally:
        ray_tpu_torch.shutdown()
    return cells, left


@pytest.mark.parametrize("affinity", [True, False])
def test_fabric_cell_passes_its_gate_as_the_reference(fabric_cells, affinity):
    cells, left = fabric_cells
    ref, port = cells["ray_tpu"][affinity], cells["ray_tpu_torch"][affinity]
    assert port_sweep._gate_kv_fabric(port) == []
    assert jax_sweep._gate_kv_fabric(ref) == []
    assert port["config"] == ref["config"] == (
        "kv_fabric_affinity" if affinity else "kv_fabric_p2c")
    assert port["knobs"] == ref["knobs"]
    assert set(port["fabric"]) == set(ref["fabric"])
    assert port["report"]["requests"] == ref["report"]["requests"] == max(NUM_REQUESTS, 12)
    assert port["fabric"]["store"]["byte_budget"] == 64 << 20
    assert port["scenario"]["name"] == "multiturn" and port["device"] == "cpu"
    for engine in port["fabric"]["per_engine"].values():
        assert engine["fabric_timeouts"] == 0
    assert port["fabric"]["repeat_wave_ttft_p50_s"] > 0
    # The reference's cell leaves its store alive, with every block it
    # holds (ROADMAP §D12); the port's teardown kills it after the engines.
    assert left["engines"] == left["stores"] == []
    assert left["reference stores"] == [f"kv_fabric:{c}-r{RATE:g}-s{SEED}"
                                        for c in ("kv_fabric_affinity", "kv_fabric_p2c")]


def test_run_sweep_runs_and_gates_the_fabric_pair(monkeypatch, capsys):
    """After the collapse cell, run_sweep runs the pair (affinity on, then
    off) at the first rate with half the requests (at least 12), gates
    each with _gate_kv_fabric and prints its line; the record's note names
    the pair."""
    calls = []

    def cell(config, **extra):
        return {"config": config, "rate": RATE, "report": {"num_errors": 0, "errors": {}},
                "slo": {"loose": {"passed": True}, "impossible": {"passed": False}},
                "engine": {}, **extra}

    def fabric_cell(affinity, rate, n, seed, **kw):
        calls.append(("fabric", affinity, rate, n, seed, kw["device"]))
        return cell("kv_fabric_affinity" if affinity else "kv_fabric_p2c",
                    fabric={"flushed_blocks": 3, "cross_replica_hit_blocks": 0 if affinity else 2,
                            "repeat_wave_ttft_p50_s": 0.01})

    def collapse(*a, **kw):
        calls.append(("collapse",))
        return cell("collapse_ramp", arrival={"ramp_to_rate": 400.0},
                    report={"completed": 1, "num_shed": 1, "num_failures": 0,
                            "shed_latency_s": {}, "num_errors": 0},
                    burn_rates={})

    def drain(*a, **kw):
        calls.append(("drain",))
        return cell("drain_scale_down", drain={})

    monkeypatch.setattr(port_sweep, "run_drain_cell", drain)
    monkeypatch.setattr(port_sweep, "run_collapse_cell", collapse)
    monkeypatch.setattr(port_sweep, "_gate_drain", lambda c: [])
    monkeypatch.setattr(port_sweep, "_gate_collapse", lambda c: [])
    monkeypatch.setattr(port_sweep, "run_kv_fabric_cell", fabric_cell)
    record, problems = port_sweep.run_sweep([RATE, 12.0], 8, configs=[], device="cpu")
    assert calls == [("drain",), ("collapse",), ("fabric", True, RATE, 12, 0, "cpu"),
                     ("fabric", False, RATE, 12, 0, "cpu")]
    assert [c["config"] for c in record["cells"][-2:]] == ["kv_fabric_affinity", "kv_fabric_p2c"]
    assert problems == [f"kv_fabric_affinity@{RATE}: no cross-replica fabric hit "
                        "(restore delta 0)"]
    assert "kv_fabric_affinity / kv_fabric_p2c" in record["note"]
    printed = capsys.readouterr().out
    assert "kv_fabric_p2c @ 6/s: errors 0, cross-replica hits 2 blocks" in printed
