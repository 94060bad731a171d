"""The trainer's dataset path on the port against the reference's.

`prepare_batch` repairs: numpy leaves become tensors on the session's
device (the reference's `jax.device_put` makes every leaf a device array;
the port used to return numpy arrays as they were), and a batch read through
a profiled dataset iterator is counted once on the samples clock (the
reference counts it in the iterator and skips it in `prepare_batch`).

Then `TorchTrainer(device="cpu")` against `JaxTrainer` on the same seeded
Dataset: two ranks through one shared `streaming_split` coordinator over two
epochs read the reference ranks' rows; a delayed rank is flagged a
straggler in `data_wait` with the pipeline's slowest operator blamed; and a
tiny GPT (2 layers, width 64, S 32) trained three steps from a Dataset from
`params_from_flax` weights gives the reference's losses within 1e-5
relative (the limit of tests/test_torch_trainer.py's parity test).

A deliberate difference is pinned last: device batches keep numpy's dtype
(int64 stays int64, as `F.cross_entropy` wants), where JAX with x64 off
narrows int64 to int32 and float64 to float32. The values agree.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

import ray_tpu
import ray_tpu.data as jd
import ray_tpu_torch
import ray_tpu_torch.data as rd
from ray_tpu.models.gpt import GPT as JaxGPT
from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_tpu.models.gpt import cross_entropy_loss as jax_cross_entropy
from ray_tpu.ops.fused_optim import fused_adamw as jax_fused_adamw
from ray_tpu.train import JaxTrainer
from ray_tpu_torch import train
from ray_tpu_torch._private import fault_injection as fi
from ray_tpu_torch.models import GPT, GPTConfig, params_from_flax
from ray_tpu_torch.models.gpt import cross_entropy_loss
from ray_tpu_torch.ops import fused_adamw
from ray_tpu_torch.train import ScalingConfig, TorchBackendConfig, TorchTrainer, TrainConfig
from ray_tpu_torch.train import observability as tobs
from ray_tpu_torch.util import metrics

torch.set_num_threads(1)

CPU = TorchBackendConfig(device="cpu")
LOSS_RTOL = 1e-5  # tests/test_torch_trainer.py's limit for the same model
TINY = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64, max_seq_len=128)
LR = 1e-3
STEPS, BATCH, SEQ = 3, 2, 32


@pytest.fixture(autouse=True)
def _isolation():
    tobs.reset_runs()
    yield
    tobs.reset_runs()
    fi.clear()


@pytest.fixture
def runtime():
    rt = ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield rt
    ray_tpu_torch.shutdown()


def _fit(loop, num_workers=1, **kwargs):
    result = TorchTrainer(
        loop, backend_config=CPU,
        scaling_config=ScalingConfig(num_workers=num_workers), **kwargs,
    ).fit()
    assert result.error is None, result.error
    return result


# ------------------------------------------------------ prepare_batch repairs


@pytest.mark.parametrize("instrument", [False, True])
def test_prepare_batch_puts_numpy_leaves_on_the_session_device(runtime, instrument):
    """A numpy batch (as `iter_batches` gives) comes back as tensors on the
    session's device, of numpy's dtype; tensor leaves move as before."""

    def loop(config):
        out = train.prepare_batch({"x": np.arange(6).reshape(3, 2),
                                   "y": np.float32(2.5),
                                   "w": np.ones((2, 3))[:, ::2],
                                   "t": torch.ones(2)})
        train.report({
            "types": {k: type(v).__name__ for k, v in out.items()},
            "devices": {k: str(v.device) for k, v in out.items()},
            "dtypes": {k: str(v.dtype) for k, v in out.items()},
            "x": out["x"].tolist(), "y": out["y"].item(), "w": out["w"].tolist(),
        })

    m = _fit(loop, train_config=TrainConfig(instrument=instrument)).metrics
    assert m["types"] == dict.fromkeys("xywt", "Tensor")
    assert m["devices"] == dict.fromkeys("xywt", "cpu")
    assert m["dtypes"] == {"x": "torch.int64", "y": "torch.float32",
                           "w": "torch.float64", "t": "torch.float32"}
    assert m["x"] == [[0, 1], [2, 3], [4, 5]] and m["y"] == 2.5
    assert m["w"] == [[1.0, 1.0], [1.0, 1.0]]


def test_samples_are_counted_once_through_a_profiled_iterator(runtime):
    """Batches read through the profiled dataset shard and then passed to
    prepare_batch count once on the samples clock (32 rows, not 64)."""

    def loop(config):
        shard = train.get_dataset_shard("train")
        assert type(shard).__name__ == "ProfiledDataIterator"
        for batch in shard.iter_batches(batch_size=8):
            train.prepare_batch(batch)
        train.report({"done": True})

    result = _fit(loop, datasets={"train": rd.range(32, parallelism=2)},
                  train_config=TrainConfig(instrument=True))
    assert result.train_report["samples_total"] == 32


# --------------------------------------------- the trainers on one Dataset

_SEEN: dict = {}
_SEEN_LOCK = threading.Lock()


def _record_ids_loop(config):
    """Each rank reads its shard for two epochs and records its ids."""
    from ray_tpu.air import session as jax_session
    from ray_tpu_torch.air import session as port_session

    session = port_session if config["port"] else jax_session
    shard = session.get_dataset_shard("train")
    rank = session.get_world_rank()
    for epoch in range(2):
        ids = [int(v) for b in shard.iter_batches(batch_size=5, drop_last=False)
               for v in b["id"]]
        with _SEEN_LOCK:
            _SEEN[(config["port"], rank, epoch)] = ids
        session.report({"epoch": epoch})


def _ids_dataset(d):
    return d.range(103, parallelism=13).map_batches(
        lambda b: {"id": b["id"], "x": (b["id"] * 7) % 11})


def test_two_ranks_share_one_split_coordinator_as_in_the_reference():
    """Two workers, two epochs: each rank's ids equal the reference rank's,
    in order, and the ranks' ids are disjoint and cover every row."""
    _SEEN.clear()
    ray_tpu.init(num_cpus=4)
    try:
        ref = JaxTrainer(
            _record_ids_loop, train_loop_config={"port": False},
            datasets={"train": _ids_dataset(jd)},
            scaling_config=ray_tpu.train.ScalingConfig(num_workers=2),
        ).fit()
    finally:
        ray_tpu.shutdown()
    assert ref.error is None, ref.error
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    try:
        _fit(_record_ids_loop, num_workers=2, train_loop_config={"port": True},
             datasets={"train": _ids_dataset(rd)})
    finally:
        ray_tpu_torch.shutdown()
    for epoch in range(2):
        port = [_SEEN[(True, r, epoch)] for r in range(2)]
        assert port == [_SEEN[(False, r, epoch)] for r in range(2)]
        assert not set(port[0]) & set(port[1])
        assert sorted(port[0] + port[1]) == list(range(103))


def test_straggler_flagged_with_dominant_phase_and_data_blame(runtime):
    """tests/test_train_observability.py's straggler case on the port: a
    rank delayed at the train.data_wait site is flagged with data_wait as
    its dominant phase, blamed on the dataset's dominant operator, and the
    healthy rank is not flagged."""
    ds = rd.range(16, parallelism=2)

    def loop(config):
        shard = train.get_dataset_shard("train")
        for r in range(3):
            for _batch in shard.iter_batches(batch_size=4, prefetch_batches=0):
                pass
            train.report({"r": r})

    fi.inject(
        "train.data_wait", match="rank=1", action="delay",
        delay_s=0.3, times=None, every=1,
    )
    result = _fit(
        loop, num_workers=2,
        datasets={"train": ds},
        train_config=TrainConfig(straggler_factor=2.0, straggler_min_s=0.05),
    )
    fi.clear()
    rep = result.train_report
    assert rep["straggler_rounds"] >= 1
    flagged = [s for s in rep["stragglers"] if s["rank"] == 1]
    assert flagged, rep["stragglers"]
    assert all(s["phase"] == "data_wait" for s in flagged)
    assert not any(s["rank"] == 0 for s in rep["stragglers"])
    assert any(s.get("data_blame") for s in flagged)
    rounds = [r for row in rep["rounds"] for r in row["ranks"]]
    assert any(r.get("data_blame") for r in rounds if r["rank"] == 1)
    c = metrics.get_or_create(metrics.Counter, "train_straggler_rounds")
    assert c._series().get((("phase", "data_wait"),), 0) >= 1


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def _token_dataset(d, tokens):
    """The chip phase's pipeline at a small size: seeded tokens, a seeded
    global shuffle, then input and target columns."""
    return d.from_numpy(tokens).random_shuffle(seed=0).map_batches(
        lambda b: {"input": b["data"][:, :-1], "target": b["data"][:, 1:]})


def _jax_gpt_loop(config):
    from ray_tpu import train as jax_train

    model = JaxGPT(JaxGPTConfig(**TINY, dtype=jnp.float32, attention_impl="auto"))

    def loss_fn(params, inputs, targets):
        return jax_cross_entropy(model.apply(params, inputs), targets)

    step = jax.jit(jax.value_and_grad(loss_fn))
    params = config["params"]
    opt = jax_fused_adamw(LR)
    state = opt.init(params)
    shard = jax_train.get_dataset_shard("train")
    for i, batch in enumerate(shard.iter_device_batches(batch_size=BATCH)):
        loss, grads = step(params, batch["input"], batch["target"])
        params, state = opt.apply(grads, state, params)
        jax_train.report({"loss": float(loss), "step": i,
                          "first_input": np.asarray(batch["input"][:, 0]).tolist()})


def _torch_gpt_loop(config):
    device = train.get_device()
    model = GPT(GPTConfig(**TINY, dtype=torch.float32, attention_impl="auto"),
                device=device)
    model.load_state_dict(train.prepare_params(params_from_flax(config["params"])))
    params = dict(model.named_parameters())
    opt = fused_adamw(LR)
    state = opt.init(params)

    def step(batch):
        loss = cross_entropy_loss(model(batch["input"]), batch["target"])
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    step = train.prepare_step(step)
    shard = train.get_dataset_shard("train")
    for i, batch in enumerate(shard.iter_device_batches(batch_size=BATCH, device=device)):
        loss, grads = step(batch)
        _, state = opt.apply(grads, state, params)
        train.report({"loss": float(loss), "step": i,
                      "first_input": batch["input"][:, 0].tolist()})


def test_tiny_gpt_trains_from_a_dataset_as_through_jax_trainer():
    """Three steps of the tiny GPT, each on the next batch of a shuffled
    Dataset read through get_dataset_shard().iter_device_batches(), on both
    trainers from the same flax weights: the same batches, and each step's
    loss within LOSS_RTOL."""
    cfg = JaxGPTConfig(**TINY, dtype=jnp.float32, attention_impl="reference")
    flax_params = _numpy_tree(
        JaxGPT(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    tokens = np.random.RandomState(5).randint(0, 128, size=(STEPS * BATCH, SEQ + 1))
    config = {"params": flax_params}

    ray_tpu.init(num_cpus=4)
    try:
        ref = JaxTrainer(
            _jax_gpt_loop, train_loop_config=config,
            datasets={"train": _token_dataset(jd, tokens)},
            scaling_config=ray_tpu.train.ScalingConfig(num_workers=1),
        ).fit()
    finally:
        ray_tpu.shutdown()
    assert ref.error is None, ref.error
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    try:
        port = _fit(_torch_gpt_loop, train_loop_config=config,
                    datasets={"train": _token_dataset(rd, tokens)})
    finally:
        ray_tpu_torch.shutdown()

    want, got = ref.metrics_history, port.metrics_history
    assert len(got) == len(want) == STEPS
    assert [m["first_input"] for m in got] == [m["first_input"] for m in want]
    # The shuffle moved rows: the first batch is not the first rows.
    assert got[0]["first_input"] != tokens[:BATCH, 0].tolist()
    np.testing.assert_allclose([m["loss"] for m in got], [m["loss"] for m in want],
                               rtol=LOSS_RTOL)


def test_device_batches_keep_numpy_dtypes_where_jax_narrows_them():
    """The pinned difference: int64 and float64 columns stay int64 and
    float64 on the port; the reference (x64 off) gives int32 and float32.
    The values agree."""
    cols = {"i": np.arange(12, dtype=np.int64) * 1000,
            "f": np.linspace(0.0, 1.0, 12, dtype=np.float64)}
    ray_tpu.init(num_cpus=2)
    try:
        want = list(jd.from_items([{k: v[j] for k, v in cols.items()} for j in range(12)])
                    .iter_device_batches(batch_size=6))
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.init(num_cpus=2, num_gpus=0)
    try:
        got = list(rd.from_items([{k: v[j] for k, v in cols.items()} for j in range(12)])
                   .iter_device_batches(batch_size=6, device="cpu"))
    finally:
        ray_tpu_torch.shutdown()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert str(w["i"].dtype) == "int32" and str(w["f"].dtype) == "float32"
        assert g["i"].dtype == torch.int64 and g["f"].dtype == torch.float64
        np.testing.assert_array_equal(g["i"].numpy(), np.asarray(w["i"]))
        np.testing.assert_allclose(g["f"].numpy(), np.asarray(w["f"]), rtol=1e-7)
