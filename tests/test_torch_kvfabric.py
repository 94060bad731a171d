"""The port's KV fabric (ray_tpu_torch.llm.kvfabric and the engine's fabric
paths) against ray_tpu.llm's, on the same converted weights, on the CPU.

The store's byte-budgeted LRU and the affinity key give the reference's
results on the same inputs. `GPTRunner.extract_block` / `restore_block`
round-trip every pool dtype bit for bit without numpy bfloat16 (bfloat16
travels as its int16 bit pattern), never alias a pool, and carry the
reference's payload layout. With the fabric on, the engine stays
token-identical to itself with the fabric off and to the reference across
prefix caching, chunked prefill, n-gram speculation, int8 pools and the
async loop; a cold engine restores what another spilled with the
reference's counters; a slow store degrades to a counted miss; and
DisaggregatedLLM hands a prefill-role engine's blocks to a decode-role
engine token-identically to the reference's pair and to a unified engine.
"""

import pickle
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
from ray_tpu.llm import KVFabricConfig as JaxKVFabricConfig
from ray_tpu.llm import LLMEngine as JaxLLMEngine
from ray_tpu.llm.kvfabric import DisaggregatedLLM as JaxDisaggregatedLLM
from ray_tpu.llm.kvfabric import KVFabricStore as JaxKVFabricStore
from ray_tpu.llm.kvfabric import LLMPrefixAffinity as JaxLLMPrefixAffinity
from ray_tpu.llm.kvfabric import leading_block_hash as jax_leading_block_hash
from ray_tpu.llm.kvfabric import rendezvous_pick as jax_rendezvous_pick
from ray_tpu.models.gpt import GPT as JaxGPT
from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_tpu_torch import observability as port_obs
from ray_tpu_torch.exceptions import GetTimeoutError
from ray_tpu_torch.llm import EngineConfig, KVFabricConfig, LLMEngine, LLMServer
from ray_tpu_torch.llm.kvfabric import (
    DisaggregatedLLM,
    KVFabricClient,
    KVFabricStore,
    LLMPrefixAffinity,
    leading_block_hash,
    payload_nbytes,
    rendezvous_pick,
)
from ray_tpu_torch.llm.kvfabric import store as store_mod
from ray_tpu_torch.models import GPTConfig, params_from_flax
from ray_tpu_torch.util.metrics import prometheus_text

# Tiny shapes: one intra-op thread, so the suite's parallel workers keep
# their cores.
torch.set_num_threads(1)

TINY = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64, max_seq_len=128)
# One layer for the on/off matrix, as the reference's own fabric tests:
# fabric semantics are per block; the two-layer model above holds the
# multi-layer pool indexing.
TINY1 = dict(vocab_size=64, num_layers=1, num_heads=4, embed_dim=32, max_seq_len=128)
JAX = {n: JaxGPTConfig(**c, dtype=jnp.float32, attention_impl="reference")
       for n, c in (("tiny", TINY), ("tiny1", TINY1))}
PORT = {n: GPTConfig(**c, dtype=torch.float32, attention_impl="reference")
        for n, c in (("tiny", TINY), ("tiny1", TINY1))}
BASE = dict(block_size=4, num_blocks=16, max_decode_slots=4, max_blocks_per_seq=8,
            prefill_buckets=(8, 32))
BUDGET = 8 << 20
LIMIT_S = 60.0


@pytest.fixture(scope="module")
def weights():
    """Per model: (flax variables as numpy, the port's state_dict)."""
    out = {}
    for name, cfg in JAX.items():
        params = JaxGPT(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
        tree = jax.tree_util.tree_map(np.asarray, meta.unbox(params))
        out[name] = (tree, params_from_flax(tree))
    return out


@pytest.fixture(scope="module")
def runtimes():
    """Both packages' runtimes, up together: each fabric's store is an
    actor of its own package's runtime."""
    ray_tpu.init(num_cpus=8)
    ray_tpu_torch.init(num_cpus=8)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


_NAMES = iter(range(10**6))


def _fabric_name(tag):
    """A fabric name no earlier test used: a named store outlives its
    engines, and its first creation pins the byte budget."""
    return f"{tag}-{next(_NAMES)}"


def _prompts(lengths, seed, vocab=128):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(1, vocab, size=n))) for n in lengths]


def _engines(weights, model="tiny", fabric=None, **ecfg):
    """(reference engine, port engine) on the same weights and config; a
    `fabric` name gives each its own store of that name."""
    tree, state = weights[model]
    jf = pf = None
    if fabric is not None:
        jf = JaxKVFabricConfig(name=fabric, byte_budget=BUDGET)
        pf = KVFabricConfig(name=fabric, byte_budget=BUDGET)
    jax_eng = JaxLLMEngine(JAX[model], JaxEngineConfig(**BASE, kv_fabric=jf, **ecfg),
                           params=tree)
    port_eng = LLMEngine(PORT[model], EngineConfig(**BASE, kv_fabric=pf, **ecfg),
                         params=state, device="cpu")
    return jax_eng, port_eng


def _f32(key, arr):
    """A payload array as f32: the port's bfloat16 travels as int16 bits."""
    if isinstance(arr, np.ndarray) and arr.dtype == np.int16:
        return torch.from_numpy(arr.copy()).view(torch.bfloat16).float().numpy()
    return np.asarray(arr, np.float32)


# ---------------- store and affinity ----------------


def _store_script(rng):
    """A seeded sequence of store operations, with payloads of 10-60 bytes
    against a 100-byte budget: puts overflow and evict, repeats refresh."""
    ops = []
    for _ in range(40):
        kind = rng.choice(["put", "put", "get_many", "contains", "put_many"])
        keys = [int(k) for k in rng.randint(0, 8, size=rng.randint(1, 4))]
        sizes = [int(s) for s in rng.randint(10, 61, size=len(keys))]
        if rng.rand() < 0.05:
            sizes[0] = 101  # larger than the whole budget: refused
        ops.append((kind, keys, sizes))
    return ops


def _run_script(store, ops):
    out = []
    for kind, keys, sizes in ops:
        if kind == "put":
            out.append(store.put(keys[0], {"k": np.full(sizes[0], keys[0], np.uint8)}))
        elif kind == "put_many":
            out.append(store.put_many(
                [(k, {"k": np.full(s, k, np.uint8)}) for k, s in zip(keys, sizes)]))
        elif kind == "get_many":
            got = store.get_many(keys)
            out.append([None if g is None else (int(g["k"][0]), g["k"].nbytes) for g in got])
        else:
            out.append(store.contains(keys))
        # Membership of every key after each op: the eviction order.
        out.append(store.contains(list(range(8))))
    return out, store.stats()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_store_matches_reference_sequence(seed):
    """put / put_many / get_many / contains and budget overflows: the same
    results, the same residents after every op (eviction order) and the
    same stats(), including hits and misses that contains() must not move."""
    ops = _store_script(np.random.RandomState(seed))
    want = _run_script(JaxKVFabricStore(byte_budget=100), ops)
    got = _run_script(KVFabricStore(byte_budget=100), ops)
    assert got == want
    assert got[1]["bytes_used"] <= 100


def test_store_contains_leaves_recency_and_counters():
    store = KVFabricStore(byte_budget=100)
    store.put(1, {"k": np.zeros(40, np.uint8)})
    store.put(2, {"k": np.zeros(40, np.uint8)})
    before = store.stats()
    assert store.contains([1, 7]) == [True, False]
    after = store.stats()
    assert (after["hits"], after["misses"]) == (before["hits"], before["misses"])
    store.put(3, {"k": np.zeros(40, np.uint8)})  # 1 is still the LRU victim
    assert store.contains([1, 2, 3]) == [False, True, True]
    with pytest.raises(ValueError, match="byte_budget must be >= 1"):
        KVFabricStore(byte_budget=0)


@pytest.mark.parametrize("block_size", [4, 8, 16])
def test_leading_block_hash_matches_reference(block_size):
    for prompt in _prompts((1, block_size - 1, block_size, block_size + 3, 40), seed=block_size):
        want = jax_leading_block_hash(prompt, block_size)
        assert leading_block_hash(prompt, block_size) == want
        assert (want is None) == (len(prompt) < block_size)


def test_prefix_affinity_pickles_compares_and_keys_as_reference():
    fn = LLMPrefixAffinity(block_size=4)
    assert pickle.loads(pickle.dumps(fn)) == fn
    assert fn != LLMPrefixAffinity(block_size=8) and fn != JaxLLMPrefixAffinity(4)
    ref = JaxLLMPrefixAffinity(block_size=4)
    for args in (({"prompt_ids": [3, 1, 4, 1, 5, 9]},), ({"prompt_ids": [1, 2]},),
                 ({"prompt_ids": []},), ("nope",), ()):
        assert fn(args, {}) == ref(args, {})
    # The same leading block keys the same, whatever follows.
    assert fn(({"prompt_ids": [3, 1, 4, 1, 2]},), {}) == fn(({"prompt_ids": [3, 1, 4, 1, 9]},), {})
    tags = [f"replica-{i}" for i in range(4)]
    for key in range(100):
        assert rendezvous_pick(key, tags) == jax_rendezvous_pick(key, tags)


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_roles_validate_as_reference(role):
    for pkg_ecfg, pkg_fabric in ((JaxEngineConfig, JaxKVFabricConfig),
                                 (EngineConfig, KVFabricConfig)):
        with pytest.raises(ValueError, match=f'engine_role="{role}" requires kv_fabric'):
            pkg_ecfg(engine_role=role)
        pkg_ecfg(engine_role=role, kv_fabric=pkg_fabric())


# ---------------- extract and restore ----------------


@pytest.mark.parametrize("kv", ["auto", "bf16", "int8"])
def test_extract_restore_bit_identical_across_slots(weights, kv):
    """A cached block extracted, its slot overwritten, then restored into
    a different slot reads back bit for bit; the payload is host numpy
    with no bfloat16, and its bytes are kv_block_bytes()."""
    _, state = weights["tiny"]
    eng = LLMEngine(PORT["tiny"], EngineConfig(**BASE, kv_cache_dtype=kv),
                    params=state, device="cpu")
    prompts = _prompts((9, 6), seed=3)
    out = eng.generate(prompts, max_new_tokens=4)
    block, _ = eng.allocator.evictable_items()[0]
    payload = eng.runner.extract_block(block)
    kept = {k: v.copy() for k, v in payload.items() if k != "kv_dtype"}
    assert set(payload) == {"kv_dtype", "k", "v"} | ({"k_scale", "v_scale"} if kv == "int8" else set())
    assert all(isinstance(v, np.ndarray) for v in kept.values())
    assert payload_nbytes(payload) == eng.runner.kv_block_bytes()
    # The aliasing case: the source slot changes between extract and
    # restore; the payload must not.
    for _, pool in eng.runner._block_pools():
        pool[:, block] = torch.ones((), dtype=pool.dtype)
    for key, val in kept.items():
        assert payload[key].tobytes() == val.tobytes(), key
    (other,) = eng.allocator.allocate(1)
    assert other != block
    eng.runner.restore_block(other, payload)
    back = eng.runner.extract_block(other)
    assert back["kv_dtype"] == payload["kv_dtype"]
    for key, val in kept.items():
        assert back[key].dtype == val.dtype and back[key].tobytes() == val.tobytes(), key
    eng.runner.restore_block(block, back)  # put the cached block back
    eng.allocator.free([other])
    assert eng.generate(prompts, max_new_tokens=4) == out


@pytest.mark.parametrize("kv", ["auto", "bf16", "int8"])
def test_extract_matches_reference_payload(weights, kv):
    """After the same prompts on the same weights, the same cached blocks
    hold the same payload as the reference's: keys, kv_dtype, shapes and
    payload_nbytes equal; values within f32 noise (f32 pools: rtol 1e-5,
    atol 1e-6), one bf16 rounding step (bf16 pools, int8 scales) or one
    int8 code on at most 0.1% of elements."""
    jax_eng, port_eng = _engines(weights, kv_cache_dtype=kv)
    prompts = _prompts((9, 6), seed=4)
    assert port_eng.generate(prompts, max_new_tokens=4) == jax_eng.generate(prompts, max_new_tokens=4)
    items = port_eng.allocator.evictable_items()
    assert items == jax_eng.allocator.evictable_items() and items
    for block, _ in items:
        want = jax_eng.runner.extract_block(block)
        got = port_eng.runner.extract_block(block)
        assert set(got) == set(want) and got["kv_dtype"] == want["kv_dtype"]
        assert payload_nbytes(got) == payload_nbytes(want) == port_eng.runner.kv_block_bytes()
        for key in set(got) - {"kv_dtype"}:
            assert got[key].shape == want[key].shape, key
            g, w = _f32(key, got[key]), np.asarray(want[key], np.float32)
            if kv == "int8" and key in ("k", "v"):
                assert np.abs(g - w).max() <= 1.0
                assert (g != w).mean() < 1e-3
            elif kv == "auto":
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_allclose(g, w, rtol=2.0**-7, atol=1e-6)


def test_restore_refuses_mismatched_payloads(weights):
    """A payload of another kv_dtype or block shape raises ValueError, as
    the reference's does: the engine then treats it as a miss."""
    _, state = weights["tiny"]
    f32 = LLMEngine(PORT["tiny"], EngineConfig(**BASE), params=state, device="cpu")
    bf16 = LLMEngine(PORT["tiny"], EngineConfig(**BASE, kv_cache_dtype="bf16"),
                     params=state, device="cpu")
    wide = LLMEngine(PORT["tiny"], EngineConfig(**{**BASE, "block_size": 8}),
                     params=state, device="cpu")
    with pytest.raises(ValueError, match="must share kv_cache_dtype"):
        bf16.runner.restore_block(1, f32.runner.extract_block(1))
    with pytest.raises(ValueError, match="block shape"):
        f32.runner.restore_block(1, wide.runner.extract_block(1))
    jax_f32, _ = _engines(weights)
    with pytest.raises(ValueError, match="block shape"):
        jax_f32.runner.restore_block(1, wide.runner.extract_block(1))


def test_budget_smaller_than_one_block_refused(weights, runtimes):
    _, state = weights["tiny"]
    tree = weights["tiny"][0]
    small = dict(BASE, kv_fabric=None)
    for make in (
        lambda: JaxLLMEngine(JAX["tiny"], JaxEngineConfig(
            **{**small, "kv_fabric": JaxKVFabricConfig(byte_budget=16)}), params=tree),
        lambda: LLMEngine(PORT["tiny"], EngineConfig(
            **{**small, "kv_fabric": KVFabricConfig(byte_budget=16)}), params=state,
            device="cpu"),
        lambda: LLMServer(PORT["tiny"], EngineConfig(
            **{**small, "kv_fabric": KVFabricConfig(byte_budget=16)}), params=state,
            device="cpu"),
    ):
        with pytest.raises(ValueError, match="cannot hold a single block"):
            make()


def test_payload_crosses_the_store_actor_byte_exact(weights, runtimes):
    _, state = weights["tiny"]
    eng = LLMEngine(PORT["tiny"], EngineConfig(**BASE, kv_cache_dtype="int8"),
                    params=state, device="cpu")
    eng.generate(_prompts((9,), seed=5), max_new_tokens=4)
    block, block_hash = eng.allocator.evictable_items()[0]
    payload = eng.runner.extract_block(block)
    client = KVFabricClient(_fabric_name("exact"), byte_budget=BUDGET)
    assert client.put(block_hash, payload)
    (got,) = client.get_many([block_hash])
    assert got["kv_dtype"] == payload["kv_dtype"]
    for key in set(payload) - {"kv_dtype"}:
        assert isinstance(got[key], np.ndarray)
        assert got[key].tobytes() == payload[key].tobytes()


# ---------------- engine behaviour ----------------

FABRIC_COUNTERS = ("fabric_restore_blocks", "fabric_hit_blocks",
                   "fabric_restored_tokens", "prefix_cache_hit_tokens")


MATRIX = {
    "prefix": {},
    "chunked": {"max_prefill_tokens_per_step": 8},
    "spec_ngram": {"speculation": "ngram", "num_speculative_tokens": 3},
    "int8": {"kv_cache_dtype": "int8"},
}


@pytest.mark.parametrize("feature", sorted(MATRIX))
def test_greedy_identity_fabric_on_vs_off(weights, runtimes, feature):
    """Same tokens with the fabric on or off, and the reference's with it
    on, per feature. The prompts run twice (prefix hits and a fully cached
    block-aligned prompt, the copy-on-write shape), then longer prompts
    flood the pool, so admission evicts the cached blocks (with the fabric
    on they spill), then the first prompts come back (with the fabric on,
    as restores)."""
    prompts = _prompts((9, 8, 5), seed=6, vocab=64)
    flood = _prompts((12, 11, 10), seed=60, vocab=64)
    name = _fabric_name(f"matrix-{feature}")
    jax_on, port_on = _engines(weights, "tiny1", fabric=name, **MATRIX[feature])
    _, port_off = _engines(weights, "tiny1", **MATRIX[feature])
    outs = {}
    for mode, eng in (("ref", jax_on), ("on", port_on), ("off", port_off)):
        runs = [eng.generate(p, max_new_tokens=6) for p in (prompts, prompts, flood, prompts)]
        assert runs[0] == runs[1] == runs[3], f"{feature}/{mode}: cached repeat diverged"
        assert eng.stats()["prefix_cache_hit_tokens"] > 0
        outs[mode] = runs
    assert outs["on"] == outs["off"] == outs["ref"]
    stats, ref = port_on.stats(), jax_on.stats()
    assert stats["fabric_spill_blocks"] > 0 and stats["fabric_restore_blocks"] > 0
    assert stats["fabric_timeouts"] == 0
    for key in FABRIC_COUNTERS + ("fabric_spill_blocks",):
        assert stats[key] == ref[key], key


def _cold_restore(jax_or_port, cfg, state_or_tree, prompts, fabric_cfg, device):
    """Engine A serves `prompts` and flushes into the fabric; a cold engine
    B on the same fabric serves them again → (A's tokens, B's tokens,
    B's stats, B's flight steps, flushed count)."""
    engine_cls, ecfg_cls = jax_or_port
    ecfg = ecfg_cls(**BASE, kv_fabric=fabric_cfg, instrument=True)
    kw = {"device": device} if device else {}
    a = engine_cls(cfg, ecfg, params=state_or_tree, **kw)
    out_a = a.generate(prompts, max_new_tokens=5)
    flushed = a.flush_kv_fabric()
    b = engine_cls(cfg, ecfg, params=state_or_tree, **kw)
    out_b = b.generate(prompts, max_new_tokens=5)
    return out_a, out_b, b.stats(), b.flight_recorder.snapshot()["steps"], flushed


def test_cold_engine_restores_with_the_reference_counters(weights, runtimes):
    """The spill tier end to end: a cold engine serves another's flushed
    prompts from fabric restores, token-identically, with the reference's
    restore, hit and prefix-hit counts; every restorable block comes back
    ((n - 1) // block_size a prompt: the last token is always recomputed)."""
    tree, state = weights["tiny"]
    prompts = _prompts((12, 9), seed=7)
    name = _fabric_name("coldstart")
    ref = _cold_restore((JaxLLMEngine, JaxEngineConfig), JAX["tiny"], tree, prompts,
                        JaxKVFabricConfig(name=name, byte_budget=BUDGET), None)
    port = _cold_restore((LLMEngine, EngineConfig), PORT["tiny"], state, prompts,
                         KVFabricConfig(name=name, byte_budget=BUDGET), "cpu")
    assert port[0] == port[1] == ref[0] == ref[1]
    assert port[4] == ref[4] >= 3
    for key in FABRIC_COUNTERS:
        assert port[2][key] == ref[2][key], key
    restorable = sum((len(p) - 1) // BASE["block_size"] for p in prompts)
    assert port[2]["fabric_restore_blocks"] == restorable
    assert port[2]["fabric_restored_tokens"] == restorable * BASE["block_size"]
    assert port[2]["fabric_timeouts"] == 0
    # Both "rates" divide by the tokens fed to prefill programs, which
    # leave the hits out, so a mostly restored workload reads above 1 in
    # both packages (ROADMAP §D13): 16 restored tokens over 5 fed.
    for key in ("fabric_hit_rate", "prefix_cache_hit_rate"):
        assert port[2][key] == ref[2][key] == 16 / 5, key
    store = port[2]["fabric_store"]
    assert store["hits"] >= restorable and store["byte_budget"] == BUDGET


def test_fabric_observability(weights, runtimes):
    """Counters in stats() and the exposition; per-step
    fabric_restored_blocks and fabric_wait_s in the flight record; and a
    replica ledger whose fabric_wait_s column is > 0 when restores ran."""
    _, state = weights["tiny"]
    name = _fabric_name("obs")
    out_a, out_b, stats, steps, flushed = _cold_restore(
        (LLMEngine, EngineConfig), PORT["tiny"], state, _prompts((12,), seed=8),
        KVFabricConfig(name=name, byte_budget=BUDGET), "cpu")
    assert out_a == out_b and flushed > 0
    assert stats["kv_fabric"] == name and stats["engine_role"] == "unified"
    assert sum(s.get("fabric_restored_blocks", 0) for s in steps) == stats["fabric_restore_blocks"] > 0
    restoring = [s for s in steps if s.get("fabric_restored_blocks")]
    assert restoring and all(s["fabric_wait_s"] > 0 for s in restoring)
    ledger = port_obs.replica_ledger(steps, model_params=stats["model_params"])
    assert ledger["columns"]["fabric_wait_s"] > 0
    assert 0.95 <= ledger["coverage"] <= 1.05
    text = prometheus_text()
    for series in ("llm_engine_fabric_restore_blocks", "llm_engine_fabric_hit_rate",
                   "llm_engine_fabric_bytes_used", "llm_engine_fabric_timeouts"):
        assert series in text, series


def test_slow_store_degrades_to_a_counted_miss(weights, runtimes, monkeypatch):
    """Every store RPC bounded: a stalled one degrades to the miss a dead
    store gives (put_many gets 6x the bound) and fires on_timeout; an
    engine behind a stalled store serves the right tokens with no restore
    and counts each timeout in stats() and llm_engine_fabric_timeouts."""
    fired, seen = [], []
    client = KVFabricClient(_fabric_name("timeouty"), byte_budget=1 << 20,
                            rpc_timeout_s=1.5, on_timeout=lambda: fired.append(1))

    def stalled_get(ref, timeout=None):
        seen.append(timeout)
        raise GetTimeoutError("injected store stall")

    payload = {"k": np.zeros(16, np.uint8)}
    monkeypatch.setattr(store_mod.ray_tpu_torch, "get", stalled_get)
    assert client.put(1, payload) is False
    assert client.put_many([(2, payload)]) == 0
    assert client.get_many([1, 2]) == [None, None]
    assert client.contains([1]) == [False]
    assert client.stats() == {}
    assert client.num_timeouts == len(fired) == 5
    assert seen == [1.5, 9.0, 1.5, 1.5, 1.5]
    assert client.put_many([]) == 0 and client.contains([]) == []
    monkeypatch.undo()
    assert client.put(99, payload) is True and client.contains([99]) == [True]

    _, state = weights["tiny"]
    name = _fabric_name("stall")
    ecfg = EngineConfig(**BASE, kv_fabric=KVFabricConfig(name=name, byte_budget=BUDGET,
                                                         rpc_timeout_s=0.5))
    prompts = _prompts((12,), seed=9)
    a = LLMEngine(PORT["tiny"], ecfg, params=state, device="cpu")
    want = a.generate(prompts, max_new_tokens=4)
    assert a.flush_kv_fabric() > 0
    b = LLMEngine(PORT["tiny"], ecfg, params=state, device="cpu")
    assert b._fabric._timeout == 0.5
    monkeypatch.setattr(store_mod.ray_tpu_torch, "get", stalled_get)
    got = b.generate(prompts, max_new_tokens=4)
    monkeypatch.undo()
    stats = b.stats()
    assert got == want
    assert stats["fabric_restore_blocks"] == 0 and stats["fabric_timeouts"] > 0
    assert "llm_engine_fabric_timeouts" in prometheus_text()


def test_fabric_off_leaves_every_hook_dark(weights):
    _, state = weights["tiny1"]
    eng = LLMEngine(PORT["tiny1"], EngineConfig(**BASE, instrument=True), params=state,
                    device="cpu")
    assert eng.allocator.on_evict is None and eng.scheduler.fabric_probe is None
    assert eng._fabric is None and not eng._publish_on_fill
    eng.generate(_prompts((9,), seed=10, vocab=64), max_new_tokens=3)
    stats = eng.stats()
    assert stats["kv_fabric"] == "off" and stats["engine_role"] == "unified"
    assert not stats["fabric_store"] and eng.flush_kv_fabric() == 0
    steps = eng.flight_recorder.snapshot()["steps"]
    assert all("fabric_restored_blocks" not in s and s["fabric_wait_s"] == 0 for s in steps)


def test_async_identity_with_the_fabric(weights, runtimes):
    """The fabric hooks see only committed state: async on, async off and
    the reference give the same tokens through the matrix test's passes
    (repeat, flood, return), the async engine really chained, and its
    restores ran beside the loop without a timeout."""
    prompts = _prompts((9, 8, 5), seed=6, vocab=64)
    flood = _prompts((12, 11, 10), seed=60, vocab=64)
    passes = (prompts, prompts, flood, prompts)
    tree, state = weights["tiny1"]
    outs = {}
    for mode in (False, True):
        eng = LLMEngine(PORT["tiny1"], EngineConfig(
            **BASE, async_scheduling=mode, instrument=True,
            kv_fabric=KVFabricConfig(name=_fabric_name(f"async-{mode}"), byte_budget=BUDGET)),
            params=state, device="cpu")
        outs[mode] = [eng.generate(p, max_new_tokens=6) for p in passes]
        stats = eng.stats()
        assert stats["fabric_restore_blocks"] > 0 and stats["fabric_timeouts"] == 0
        if mode:
            steps = eng.flight_recorder.snapshot()["steps"]
            assert any(s.get("chained") for s in steps)
            assert stats["inflight_steps"] == 0
    ref = JaxLLMEngine(JAX["tiny1"], JaxEngineConfig(
        **BASE, async_scheduling=True,
        kv_fabric=JaxKVFabricConfig(name=_fabric_name("async-ref"), byte_budget=BUDGET)),
        params=tree)
    assert outs[True] == outs[False] == [ref.generate(p, max_new_tokens=6) for p in passes]


def test_disaggregated_matches_reference_and_unified(weights, runtimes):
    """DisaggregatedLLM: the prefill-role engine publishes every full block
    as its chunk fills, the decode-role engine restores (n - 1) // bs of
    them a request, and the tokens equal the reference pair's and a
    unified engine's."""
    tree, state = weights["tiny"]
    prompts = _prompts((11, 6), seed=9)
    want = JaxLLMEngine(JAX["tiny"], JaxEngineConfig(**BASE), params=tree).generate(
        prompts, max_new_tokens=6)
    unified = LLMEngine(PORT["tiny"], EngineConfig(**BASE), params=state, device="cpu")
    assert unified.generate(prompts, max_new_tokens=6) == want
    name = _fabric_name("disagg")
    ref = JaxDisaggregatedLLM(JAX["tiny"], JaxEngineConfig(
        **BASE, kv_fabric=JaxKVFabricConfig(name=name, byte_budget=BUDGET)),
        params=tree, name=name)
    port = DisaggregatedLLM(PORT["tiny"], EngineConfig(
        **BASE, kv_fabric=KVFabricConfig(name=name, byte_budget=BUDGET)),
        params=state, name=name, device="cpu")
    try:
        for prompt, expect in zip(prompts, want):
            assert port.generate(prompt, max_new_tokens=6)["token_ids"] == expect
            assert ref.generate(prompt, max_new_tokens=6)["token_ids"] == expect
        pstats, dstats = port.prefill_stats(), port.decode_stats()
        assert (pstats["engine_role"], dstats["engine_role"]) == ("prefill", "decode")
        full = sum(len(p) // BASE["block_size"] for p in prompts)
        restorable = sum((len(p) - 1) // BASE["block_size"] for p in prompts)
        assert pstats["fabric_spill_blocks"] == full
        assert dstats["fabric_restore_blocks"] == restorable
        assert dstats["fabric_timeouts"] == pstats["fabric_timeouts"] == 0
        for key in FABRIC_COUNTERS + ("fabric_spill_blocks",):
            assert dstats[key] == ref.decode_stats()[key], key
            assert pstats[key] == ref.prefill_stats()[key], key
    finally:
        port.shutdown()
        ref.shutdown()


def test_server_warmup_leaves_the_store_empty(weights, runtimes):
    """Warmup runs with every fabric hook off: two servers on one fabric
    warm up without a put, a probe or a restore, and the hooks are back
    afterwards (the first real request publishes)."""
    _, state = weights["tiny"]
    name = _fabric_name("warm")
    ecfg = EngineConfig(**{**BASE, "num_blocks": 12},
                        kv_fabric=KVFabricConfig(name=name, byte_budget=BUDGET))
    servers = [LLMServer(PORT["tiny"], ecfg, params=state, device="cpu") for _ in range(2)]
    try:
        client = KVFabricClient(name, BUDGET)
        stats = client.stats()
        assert (stats["num_blocks"], stats["puts"], stats["hits"], stats["misses"]) == (0, 0, 0, 0)
        for s in servers:
            m = s.metrics()
            assert m["fabric_restore_blocks"] == m["fabric_spill_blocks"] == m["fabric_hit_blocks"] == 0
            assert s.engine.allocator.on_evict is not None
            assert s.engine.scheduler.fabric_probe is not None
        servers[0].generate(_prompts((12,), seed=11)[0], max_new_tokens=2, timeout_s=LIMIT_S)
        assert servers[0].flush_kv_fabric() > 0
    finally:
        for s in servers:
            s.shutdown()
    deadline = time.monotonic() + LIMIT_S
    while time.monotonic() < deadline and not client.stats().get("num_blocks"):
        time.sleep(0.05)
    assert client.stats()["num_blocks"] > 0
