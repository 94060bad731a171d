"""ray_tpu_torch.llm at tensor_parallel_size 2 (gloo on the CPU): pool
bytes, fail-fast validation, a poison request, a dead rank, and the KV
fabric across engines of different tp (counterparts of the rest of
tests/test_llm_tp.py, plus what only a process per rank can do: die).

Weights are the reference engine's (seed 0) through `params_from_flax`,
f32. Engines here start their own ranks unless they share the file's
`group`; every wait is bounded (the group's collective timeout, and the
servers' generate timeouts).
"""

import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
from flax.linen import meta

import jax.numpy as jnp
import ray_tpu_torch
from ray_tpu.llm import EngineConfig as JaxEngineConfig
from ray_tpu.llm import LLMEngine as JaxLLMEngine
from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_tpu_torch._private import fault_injection as fi
from ray_tpu_torch.exceptions import PoisonRequestError
from ray_tpu_torch.llm import EngineConfig, KVFabricConfig, LLMEngine, LLMServer
from ray_tpu_torch.llm import engine as engine_module
from ray_tpu_torch.models import GPTConfig, params_from_flax
from ray_tpu_torch.parallel import (
    TensorParallelError,
    check_tp_devices,
    tensor_parallel_group,
)

torch.set_num_threads(1)

SHAPE = dict(vocab_size=64, num_layers=1, num_heads=4, embed_dim=32, max_seq_len=128)
DRAFT_SHAPE = dict(vocab_size=64, num_layers=1, num_heads=2, embed_dim=16, max_seq_len=128)
JAX_TINY = JaxGPTConfig(**SHAPE, dtype=jnp.float32, attention_impl="reference")
TINY = GPTConfig(**SHAPE, dtype=torch.float32, attention_impl="reference")
JAX_DRAFT = JaxGPTConfig(**DRAFT_SHAPE, dtype=jnp.float32, attention_impl="reference")
DRAFT = GPTConfig(**DRAFT_SHAPE, dtype=torch.float32, attention_impl="reference")
BASE = dict(block_size=4, num_blocks=64, max_decode_slots=4, max_blocks_per_seq=16)
HEAD_SPEC = "PartitionSpec(None, None, None, 'tp')"
# A dead rank makes the next program raise at once (the liveness check
# before every dispatch), and a program it dies inside raise as soon as
# rank 0's collective fails; this bounds both with room for a loaded box.
DEAD_RANK_BOUND_S = 10.0


def random_prompts(lengths, vocab=64, seed=0):
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(0, vocab, size=n))) for n in lengths]


def host_params(params):
    return params_from_flax(jax.tree_util.tree_map(np.asarray, meta.unbox(params)))


@pytest.fixture(scope="module")
def _ranks():
    g = tensor_parallel_group(2, "cpu")
    yield g
    g.close()


@pytest.fixture
def group(_ranks, monkeypatch):
    """The file's two CPU ranks, handed to every tp=2 engine the test
    makes in place of the engine's own spawn; an engine's shutdown then
    drops only its runners' shards and leaves the ranks up."""
    monkeypatch.setattr(engine_module, "tensor_parallel_group", lambda tp, device: _ranks)
    monkeypatch.setattr(_ranks, "close", lambda: None)
    return _ranks


@pytest.fixture(scope="module")
def weights():
    ref = JaxLLMEngine(JAX_TINY, JaxEngineConfig(**BASE), seed=0)
    return ref, host_params(ref.runner.params)


@pytest.fixture(autouse=True)
def _clear_faults():
    yield
    fi.clear()


def _gone(procs, within_s=10.0):
    deadline = time.monotonic() + within_s
    while time.monotonic() < deadline:
        if all(p.poll() is not None for p in procs):
            return True
        time.sleep(0.05)
    return False


def test_tp2_pool_bytes_per_shard_is_aggregate_over_tp(group, weights):
    e2 = LLMEngine(TINY, EngineConfig(tensor_parallel_size=2, **BASE),
                   params=weights[1], device="cpu")
    stats = e2.stats()
    assert stats["tensor_parallel_size"] == 2
    assert stats["kv_pool_bytes_per_shard"] * 2 == stats["kv_pool_bytes"]
    r = e2.runner
    assert r.k_cache.nbytes + r.v_cache.nbytes == stats["kv_pool_bytes_per_shard"]
    s1 = LLMEngine(TINY, EngineConfig(**BASE), params=weights[1], device="cpu").stats()
    assert s1["kv_pool_bytes_per_shard"] == s1["kv_pool_bytes"]
    assert s1["kv_pool_sharding"] is None
    assert s1["model_params"] == stats["model_params"]
    e2.shutdown()


def _no_new_ranks(fn):
    """Run fn (which must raise) and show it started no rank process."""
    before = {t.pid for t in _children()}
    fn()
    assert {t.pid for t in _children()} <= before


def _children():
    import psutil

    return psutil.Process().children(recursive=True)


def test_tp_must_divide_target_heads():
    with pytest.raises(ValueError, match="num_heads 4 is not divisible"):
        _no_new_ranks(lambda: LLMEngine(
            TINY, EngineConfig(tensor_parallel_size=3, **BASE), device="cpu"))


def test_tp_must_divide_draft_heads():
    # Target heads (4) divide tp=4 but the draft's (2) do not: the error
    # names the draft model, and comes before any rank starts.
    with pytest.raises(ValueError, match="draft model num_heads 2"):
        _no_new_ranks(lambda: LLMEngine(
            TINY, EngineConfig(tensor_parallel_size=4, speculation="draft",
                               draft_model_config=DRAFT, **BASE), device="cpu"))


def test_tp_exceeding_visible_devices_fails_fast():
    """The check on a stated count (8 visible devices, as the reference's
    virtual CPU backend has), and the group itself refusing more CPU ranks
    than cores before it starts any."""
    with pytest.raises(ValueError, match="exceeds the 8 device"):
        check_tp_devices(16, 8, "cuda")
    check_tp_devices(8, 8, "cuda")
    too_many = (os.cpu_count() or 1) + 1
    with pytest.raises(ValueError, match=f"exceeds the {too_many - 1} device"):
        _no_new_ranks(lambda: tensor_parallel_group(too_many, "cpu"))


def test_tp_zero_rejected_at_config():
    with pytest.raises(ValueError, match="tensor_parallel_size"):
        EngineConfig(tensor_parallel_size=0)


def test_tp_reference_impl_supported(group):
    eng = LLMEngine(TINY, EngineConfig(tensor_parallel_size=2, attn_impl="reference", **BASE),
                    device="cpu")
    assert eng.runner.attn_impl == "reference"
    assert eng.runner.tensor_parallel_size == 2
    assert eng.runner.pool_sharding_spec() == HEAD_SPEC
    eng.shutdown()


def test_tp2_poison_dead_letters_only_culprit_pools_at_boot(weights):
    """A poison step on a tp=2 server (with the draft's split mirror pool
    in play) dead-letters only the culprit; the others stay
    token-identical to the reference, both pools are back at boot size and
    still split, and the server's shutdown stops its rank."""
    fi.inject("engine.verify", match="poison-me",
              exc_factory=lambda: RuntimeError("cosmic ray at tp=2"))
    prompts = random_prompts((5, 7), seed=10)
    ref = JaxLLMEngine(JAX_TINY, JaxEngineConfig(
        speculation="draft", draft_model_config=JAX_DRAFT, **BASE), seed=0)
    want = [ref.generate([p], max_new_tokens=8)[0] for p in prompts]
    server = LLMServer(
        TINY, EngineConfig(tensor_parallel_size=2, speculation="draft",
                           draft_model_config=DRAFT, **BASE),
        params=weights[1], draft_params=host_params(ref._spec.runner.params),
        warmup=False, device="cpu",
    )
    procs = server.engine._tp_group.processes
    results = {}

    def run(rid, prompt):
        try:
            results[rid] = server.generate(prompt, max_new_tokens=8, request_id=rid,
                                           timeout_s=60.0)
        except BaseException as exc:  # noqa: BLE001 - inspected below
            results[rid] = exc

    jobs = [(f"ok-{i}", p) for i, p in enumerate(prompts)]
    jobs.append(("poison-me", random_prompts((6,), seed=11)[0]))
    threads = [threading.Thread(target=run, args=j, daemon=True) for j in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    assert isinstance(results["poison-me"], PoisonRequestError)
    for i in range(len(prompts)):
        assert results[f"ok-{i}"]["token_ids"] == want[i]
    assert server.check_health() is True
    stats = server.metrics()
    assert stats["num_dead_letters"] == 1
    assert stats["tensor_parallel_size"] == 2
    assert stats["kv_pool_allocated"] == 0
    assert stats["spec_draft_pool_allocated"] == 0
    assert stats["kv_pool_sharding"] == HEAD_SPEC
    assert server.engine._spec.runner.pool_sharding_spec() == HEAD_SPEC
    server.shutdown()
    assert _gone(procs)


def test_dead_rank_raises_typed_error_within_bound(weights):
    """SIGKILL rank 1 between requests: the next request fails with
    TensorParallelError within DEAD_RANK_BOUND_S (no hang, no dead-letter
    pinned on the request), the server reports unhealthy, and its
    shutdown still returns."""
    server = LLMServer(TINY, EngineConfig(tensor_parallel_size=2, **BASE),
                       params=weights[1], device="cpu", warmup=False)
    prompt = random_prompts((6,), seed=13)[0]
    assert len(server.generate(prompt, max_new_tokens=4, timeout_s=60.0)["token_ids"]) == 4
    rank1 = server.engine._tp_group.processes[0]
    os.kill(rank1.pid, signal.SIGKILL)
    assert _gone([rank1])
    t0 = time.monotonic()
    with pytest.raises(TensorParallelError, match="rank 1"):
        server.generate(prompt, max_new_tokens=4, timeout_s=DEAD_RANK_BOUND_S)
    assert time.monotonic() - t0 < DEAD_RANK_BOUND_S
    assert server.check_health() is False
    assert server.metrics()["num_dead_letters"] == 0
    server.shutdown()


def test_rank_dying_inside_a_step_raises_typed_error_within_bound(weights):
    """Rank 1 stopped (alive, so the step's header goes out and rank 0
    enters the step's collectives) and killed a second later, while rank 0
    waits on it inside the step: the step raises TensorParallelError naming
    rank 1 within DEAD_RANK_BOUND_S of the kill instead of hanging, and the
    engine's shutdown still returns."""
    e2 = LLMEngine(TINY, EngineConfig(tensor_parallel_size=2, **BASE),
                   params=weights[1], device="cpu")
    prompt = random_prompts((6,), seed=14)[0]
    assert len(e2.generate([prompt], max_new_tokens=3)[0]) == 3
    rank1 = e2._tp_group.processes[0]
    os.kill(rank1.pid, signal.SIGSTOP)
    killer = threading.Timer(1.0, os.kill, (rank1.pid, signal.SIGKILL))
    t0 = time.monotonic()
    killer.start()
    try:
        with pytest.raises(TensorParallelError, match="rank 1"):
            e2.generate([prompt], max_new_tokens=3)
    finally:
        killer.join()
    assert time.monotonic() - t0 < 1.0 + DEAD_RANK_BOUND_S
    e2.shutdown()
    assert _gone([rank1])


class _Busy:
    """A device event that never completes: rank 0's stream stuck in a
    collective that waits on another rank."""

    def query(self):
        return False


@pytest.mark.parametrize("cause", ["rank_killed", "timeout"])
def test_fence_raises_while_rank_0_waits_on_its_device(cause, monkeypatch):
    """The card's path with the device faked. NCCL's wait() returns at once
    on the host, so rank 0 waits on its stream only through the group's
    fence. With the stream stuck, the fence raises TensorParallelError:
    naming rank 1 within DEAD_RANK_BOUND_S when rank 1 is killed, or after
    TP_TIMEOUT_S (shortened here) when every rank lives but none answers.
    It aborts the backend first, and every later call raises the same error
    at once."""
    from ray_tpu_torch.parallel import mesh

    g = tensor_parallel_group(2, "cpu")
    try:
        g.device = torch.device("cuda")
        rank1 = g.processes[0]
        if cause == "rank_killed":
            threading.Timer(0.5, os.kill, (rank1.pid, signal.SIGKILL)).start()
            match = "rank 1"
        else:
            monkeypatch.setattr(mesh, "TP_TIMEOUT_S", 0.3)
            match = "did not finish within 0.3s"
        t0 = time.monotonic()
        with pytest.raises(TensorParallelError, match=match) as err:
            g.fence(_Busy())
        assert time.monotonic() - t0 < DEAD_RANK_BOUND_S
        assert g.backend is None
        assert (rank1.poll() is None) == (cause == "timeout")
        with pytest.raises(TensorParallelError) as again:
            g.dispatch(1, 0)
        assert again.value is err.value
    finally:
        g.device = torch.device("cpu")
        g.close()


def test_fabric_blocks_cross_between_tp2_and_tp1_engines(weights):
    """One fabric, engines of different tp: a payload extracted at tp=2
    (rank 0 gathers rank 1's heads) has tp=1's bytes and layout. Blocks a
    tp=2 engine flushed restore into a cold tp=1 engine, and the other way
    round, with token-identical output; and a block copied through the
    runners round-trips bit for bit."""
    ref, w = weights
    prompts = random_prompts((12, 9), seed=7)
    want = ref.generate(prompts, max_new_tokens=5)
    ray_tpu_torch.init(num_cpus=4)
    try:
        for i, (tp_a, tp_b) in enumerate(((2, 1), (1, 2))):
            ecfg = lambda tp: EngineConfig(
                tensor_parallel_size=tp, instrument=True,
                kv_fabric=KVFabricConfig(name=f"tp-cross-{i}", byte_budget=8 << 20), **BASE)
            a = LLMEngine(TINY, ecfg(tp_a), params=w, device="cpu")
            assert a.generate(prompts, max_new_tokens=5) == want
            assert a.flush_kv_fabric() > 0
            b = LLMEngine(TINY, ecfg(tp_b), params=w, device="cpu")
            assert b.generate(prompts, max_new_tokens=5) == want
            restorable = sum((len(p) - 1) // BASE["block_size"] for p in prompts)
            assert b.stats()["fabric_restore_blocks"] == restorable
            assert b.stats()["fabric_timeouts"] == 0
            # The runners' copies, bit for bit: a's block 1 into b's 60,
            # back out of b.
            src = a.runner.extract_block(1)
            assert src["k"].shape == (1, 4, 4, 8)
            b.runner.restore_block(60, src)
            back = b.runner.extract_block(60)
            for key in ("k", "v"):
                assert back[key].tobytes() == src[key].tobytes()
            a.shutdown()
            b.shutdown()
    finally:
        ray_tpu_torch.shutdown()


def test_exception_inside_a_program_ends_the_group(weights):
    """Everything that can raise on rank 0 runs before a program's header
    goes out; an exception after it (here, one forced inside the decode
    program) may leave the ranks apart in their collectives, so the group
    ends: the exception propagates, the next program raises
    TensorParallelError at once, and rank 1 exits."""
    e2 = LLMEngine(TINY, EngineConfig(tensor_parallel_size=2, **BASE),
                   params=weights[1], device="cpu")
    r = e2.runner
    procs = e2._tp_group.processes
    slots = BASE["max_decode_slots"]
    zeros = np.zeros((slots,), np.int32)
    table = np.zeros((slots, BASE["max_blocks_per_seq"]), np.int32)

    def broken(*args):
        raise RuntimeError("forced inside the program")

    r._decode_program = broken
    with pytest.raises(RuntimeError, match="forced inside the program"):
        r.decode(zeros, zeros, table, zeros)
    t0 = time.monotonic()
    with pytest.raises(TensorParallelError, match="step program raised on rank 0"):
        r.prefill([1, 2, 3], [1])
    assert time.monotonic() - t0 < DEAD_RANK_BOUND_S
    assert _gone(procs)
    e2.shutdown()


_NO_MAIN_GUARD = """
import torch
from ray_tpu_torch.llm import EngineConfig, LLMEngine
from ray_tpu_torch.models import GPTConfig

cfg = GPTConfig(vocab_size=64, num_layers=1, num_heads=2, embed_dim=16,
                max_seq_len=64, dtype=torch.float32)
eng = LLMEngine(cfg, EngineConfig(block_size=4, num_blocks=16, max_decode_slots=2,
                                  max_blocks_per_seq=8, tensor_parallel_size=2),
                device="cpu")
print("TOKENS", eng.generate([[1, 2, 3]], max_new_tokens=3))
eng.shutdown()
"""


def test_a_script_without_a_main_guard_starts_its_ranks(tmp_path):
    """Ranks are fresh interpreters (`python -m ray_tpu_torch.llm.tp_worker`),
    not multiprocessing's spawn, which would import the caller's script in
    each rank and refuse one without an `if __name__ == "__main__"` guard."""
    script = tmp_path / "serve_tp.py"
    script.write_text(_NO_MAIN_GUARD)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    proc = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("TOKENS") == 1
