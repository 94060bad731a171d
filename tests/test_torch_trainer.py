"""ray_tpu_torch.train against the reference's Train library.

The first tests are the counterparts of tests/test_train.py, run through
`TorchTrainer` with `TorchBackendConfig(device="cpu")`: the trainer, its
worker actors on the port's in-process runtime, host collectives,
checkpoints, failure restarts. The last one trains the same tiny GPT three
steps through `ray_tpu.train.JaxTrainer` and through the port's
`TorchTrainer`, from the same flax-initialised weights and batch, and holds
the two runs to each other loss by loss and parameter by parameter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

import ray_tpu
import ray_tpu_torch
from ray_tpu.models.gpt import GPT as JaxGPT
from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_tpu.models.gpt import cross_entropy_loss as jax_cross_entropy
from ray_tpu.ops.fused_optim import fused_adamw as jax_fused_adamw
from ray_tpu.train import JaxTrainer
from ray_tpu_torch import train
from ray_tpu_torch.air import Checkpoint, session
from ray_tpu_torch.models import GPT, GPTConfig, params_from_flax
from ray_tpu_torch.models.gpt import cross_entropy_loss
from ray_tpu_torch.ops import fused_adamw
from ray_tpu_torch.train import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
    TorchBackendConfig,
    TorchTrainer,
)

torch.set_num_threads(1)

CPU = TorchBackendConfig(device="cpu")


@pytest.fixture
def runtime():
    """The port's runtime, 4 CPUs (tests/conftest.py's fixtures start the
    reference's)."""
    rt = ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield rt
    ray_tpu_torch.shutdown()


def _trainer(loop, **kwargs):
    kwargs.setdefault("scaling_config", ScalingConfig(num_workers=1))
    return TorchTrainer(loop, backend_config=CPU, **kwargs)


def test_torch_trainer_end_to_end(runtime):
    """Linear regression through trainer -> executor -> worker actor on the
    CPU device, with prepare_params / prepare_batch / prepare_step: the loss
    falls and the checkpointed weights approach the truth."""

    def train_loop(config):
        device = train.get_device()
        assert device == torch.device("cpu")
        g = torch.Generator().manual_seed(0)
        x = torch.randn(64, 8, generator=g)
        y = x @ torch.arange(1.0, 9.0)
        params = train.prepare_params({"w": torch.zeros(8)})
        batch = train.prepare_batch({"x": x, "y": y})

        def step(w):
            w = w.detach().requires_grad_()
            loss = ((batch["x"] @ w - batch["y"]) ** 2).mean()
            (grad,) = torch.autograd.grad(loss, [w])
            return (w - 0.1 * grad).detach(), float(loss.detach())

        step = train.prepare_step(step)
        for epoch in range(config["epochs"]):
            params["w"], loss = step(params["w"])
            ckpt = Checkpoint.from_dict({"w": params["w"].clone(), "epoch": epoch})
            train.report({"loss": loss, "epoch": epoch}, checkpoint=ckpt)

    result = _trainer(train_loop, train_loop_config={"epochs": 50}).fit()
    assert result.error is None
    assert result.metrics["epoch"] == 49
    assert len(result.metrics_history) == 50
    assert result.metrics_history[-1]["loss"] < result.metrics_history[0]["loss"]
    w = result.checkpoint.to_dict()["w"]
    np.testing.assert_allclose(w.numpy(), np.arange(1.0, 9.0), atol=0.5)
    # Instrumented by default: every round timed compute and data_wait.
    report = result.train_report
    assert report is not None and report["rounds_total"] == 50


def test_multi_worker_rendezvous_and_collectives(runtime):
    """4 CPU workers: report lockstep + host-collective averaging."""

    def train_loop(config):
        from ray_tpu_torch.util import collective

        rank = train.get_world_rank()
        for it in range(3):
            local_grad = np.full(4, float(rank + it))
            avg = collective.allreduce(local_grad, op="mean", group_name="train")
            train.report({"grad0": float(avg[0]), "iter": it, "rank": rank})

    result = _trainer(
        train_loop, scaling_config=ScalingConfig(num_workers=4, cpus_per_worker=1)
    ).fit()
    assert result.error is None
    # mean over ranks 0..3 at it=2 -> 1.5+2 = 3.5
    assert result.metrics["grad0"] == pytest.approx(3.5)


def test_checkpoint_resume(runtime):
    def train_loop(config):
        ckpt = train.get_checkpoint()
        start = ckpt.to_dict()["step"] + 1 if ckpt else 0
        for step in range(start, start + 2):
            train.report(
                {"step": step}, checkpoint=Checkpoint.from_dict({"step": step})
            )

    r1 = _trainer(train_loop).fit()
    assert r1.metrics["step"] == 1
    r2 = _trainer(train_loop, resume_from_checkpoint=r1.checkpoint).fit()
    assert r2.metrics["step"] == 3


def test_failure_restart_resumes_from_checkpoint(runtime):
    crashed = {"done": False}

    def train_loop(config):
        ckpt = train.get_checkpoint()
        start = ckpt.to_dict()["step"] + 1 if ckpt else 0
        for step in range(start, 4):
            if step == 2 and not crashed["done"]:
                crashed["done"] = True
                raise RuntimeError("chaos: worker died")
            train.report(
                {"step": step}, checkpoint=Checkpoint.from_dict({"step": step})
            )

    result = _trainer(
        train_loop, run_config=RunConfig(failure_config=FailureConfig(max_failures=1))
    ).fit()
    assert result.error is None
    assert result.metrics["step"] == 3
    assert crashed["done"]
    assert [m["step"] for m in result.metrics_history] == [0, 1, 2, 3]


def test_failure_exhausted_reports_error(runtime):
    def train_loop(config):
        raise ValueError("always fails")

    result = _trainer(
        train_loop, run_config=RunConfig(failure_config=FailureConfig(max_failures=1))
    ).fit()
    assert result.error is not None
    assert "always fails" in str(result.error)


def test_top_k_checkpoints(runtime):
    def train_loop(config):
        for acc in [0.1, 0.9, 0.5, 0.7]:
            train.report(
                {"acc": acc}, checkpoint=Checkpoint.from_dict({"acc": acc})
            )

    result = _trainer(
        train_loop,
        run_config=RunConfig(
            checkpoint_config=CheckpointConfig(
                num_to_keep=2, checkpoint_score_attribute="acc"
            )
        ),
    ).fit()
    assert result.checkpoint.to_dict()["acc"] == 0.9


def test_dataset_shard_list(runtime):
    def train_loop(config):
        shard = train.get_dataset_shard("train")
        session.report({"n": len(list(shard)), "rank": train.get_world_rank()})

    result = _trainer(
        train_loop,
        scaling_config=ScalingConfig(num_workers=2),
        datasets={"train": list(range(10))},
    ).fit()
    assert result.error is None
    assert result.metrics["n"] == 5


def test_tensor_checkpoint_roundtrips_bit_for_bit(runtime, tmp_path):
    """A dict checkpoint's tensor leaves survive to_directory /
    from_directory bit for bit (stored on the host), and prepare_params
    moves them to the worker's device unchanged."""
    g = torch.Generator().manual_seed(3)
    data = {
        "params": {"w": torch.randn(5, 7, generator=g),
                   "b": torch.randn(7, generator=g).bfloat16()},
        "moments": [torch.randn(3, generator=g)],
        "step": 4,
    }
    path = Checkpoint.from_dict(data).to_directory(str(tmp_path / "ckpt"))
    back = Checkpoint.from_directory(path).to_dict()
    assert back["step"] == 4
    for got, want in ((back["params"]["w"], data["params"]["w"]),
                      (back["params"]["b"], data["params"]["b"]),
                      (back["moments"][0], data["moments"][0])):
        assert got.device.type == "cpu" and got.dtype == want.dtype
        assert torch.equal(got, want)

    def train_loop(config):
        moved = train.prepare_params(Checkpoint.from_directory(path).to_dict()["params"])
        same = all(torch.equal(moved[k].cpu(), data["params"][k]) for k in moved)
        train.report({"same": same, "device": str(moved["w"].device)})

    result = _trainer(train_loop).fit()
    assert result.error is None
    assert result.metrics["same"] and result.metrics["device"] == "cpu"


def test_cuda_default_and_refusals():
    """The backend defaults to CUDA and raises without it (the CPU only
    when asked for); the reference's options the port does not carry are
    refused with the slice that would bring them, and the lifted ones
    (as_trainable, Dataset shards in datasets=) work."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TorchBackendConfig()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TorchTrainer(lambda: None)
    with pytest.raises(NotImplementedError, match="§B7"):
        TorchBackendConfig(device="cpu", mesh_strategy="fsdp")
    with pytest.raises(NotImplementedError, match="§B7"):
        TorchBackendConfig(device="cpu", multihost=True)
    # Tune over the trainer is ported: as_trainable gives a Trainable class.
    from ray_tpu_torch.tune import Trainable

    trainable = _trainer(lambda: None).as_trainable()
    assert isinstance(trainable, type) and issubclass(trainable, Trainable)

    class FakeDataset:
        def streaming_split(self, n):
            return [self] * n

    # Dataset shards are ported: rank r of n gets the r-th of one split.
    ds = FakeDataset()
    trainer = _trainer(lambda: None, datasets={"train": ds, "eval": [0, 1, 2, 3]})
    assert trainer._dataset_shard_fn(1, 2) == {"train": ds, "eval": [1, 3]}


# ------------------------------------------------------------ the slice

TINY = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64, max_seq_len=128)
LR = 1e-3
STEPS = 3


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def _jax_loop(config):
    """Three fused_adamw steps of the flax GPT on one batch, reporting the
    loss of each and the final parameters."""
    from ray_tpu import train as jax_train

    model = JaxGPT(JaxGPTConfig(**TINY, dtype=jnp.float32, attention_impl="auto"))

    def loss_fn(params, tokens):
        logits = model.apply(params, tokens)
        return jax_cross_entropy(logits[:, :-1], tokens[:, 1:])

    step = jax.jit(jax.value_and_grad(loss_fn))
    params = config["params"]
    opt = jax_fused_adamw(LR)
    state = opt.init(params)
    tokens = jnp.asarray(config["tokens"])
    for i in range(STEPS):
        loss, grads = step(params, tokens)
        params, state = opt.apply(grads, state, params)
        ckpt = None
        if i == STEPS - 1:
            ckpt = ray_tpu.air.Checkpoint.from_dict({"params": _numpy_tree(params)})
        jax_train.report({"loss": float(loss), "step": i}, checkpoint=ckpt)


def _torch_loop(config):
    """The same three steps through the port: GPT on the worker's device
    with the flax weights, prepare_batch / prepare_step, fused_adamw."""
    device = train.get_device()
    model = GPT(GPTConfig(**TINY, dtype=torch.float32, attention_impl="auto"),
                device=device)
    model.load_state_dict(train.prepare_params(params_from_flax(config["params"])))
    params = dict(model.named_parameters())
    opt = fused_adamw(LR)
    state = opt.init(params)
    tokens = train.prepare_batch(torch.from_numpy(config["tokens"]).long())

    def step():
        logits = model(tokens)
        loss = cross_entropy_loss(logits[:, :-1], tokens[:, 1:])
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    step = train.prepare_step(step)
    for i in range(STEPS):
        loss, grads = step()
        _, state = opt.apply(grads, state, params)
        ckpt = None
        if i == STEPS - 1:
            ckpt = Checkpoint.from_dict(
                {"params": {k: p.detach().clone() for k, p in params.items()}}
            )
        train.report({"loss": float(loss), "step": i}, checkpoint=ckpt)


def test_tiny_gpt_trains_the_same_through_both_trainers(runtime):
    """The slice as a whole: a tiny GPT (2 layers, width 64, 4 heads) takes
    three fused_adamw steps through `JaxTrainer` and through `TorchTrainer`
    (device="cpu"), from the same flax-initialised weights and the same
    seeded batch, attention_impl="auto" on both sides (the reference op on
    the CPU). f32: each step's loss within 1e-5 relative, and every final
    parameter within 1e-4 relative L2 (the limit chip_smoke.py holds the
    card's f32 step to), but the key third of each attn_qkv bias, whose
    exact gradient is zero so both sides' Adam steps there follow rounding
    noise (see tests/test_torch_train.py). Adam's first steps are about ±lr
    whatever a gradient's size, so where a gradient is near zero the two
    sides' f32 summation orders move single elements by up to lr: the
    worst leaf measured here is 1.6e-5 (h.1.mlp_out.weight), the losses
    agree to 1e-7."""
    cfg = JaxGPTConfig(**TINY, dtype=jnp.float32, attention_impl="reference")
    flax_params = _numpy_tree(
        JaxGPT(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    )
    tokens = np.random.RandomState(5).randint(0, 128, size=(2, 32)).astype(np.int32)
    config = {"params": flax_params, "tokens": tokens}

    ray_tpu.init(num_cpus=4)
    try:
        jax_result = JaxTrainer(
            _jax_loop, train_loop_config=config,
            scaling_config=ray_tpu.train.ScalingConfig(num_workers=1),
        ).fit()
    finally:
        ray_tpu.shutdown()
    torch_result = _trainer(_torch_loop, train_loop_config=config).fit()
    assert jax_result.error is None and torch_result.error is None

    want = [m["loss"] for m in jax_result.metrics_history]
    got = [m["loss"] for m in torch_result.metrics_history]
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]

    want_params = params_from_flax(jax_result.checkpoint.to_dict()["params"])
    got_params = torch_result.checkpoint.to_dict()["params"]
    assert set(got_params) == set(want_params)
    key_third = slice(TINY["embed_dim"], 2 * TINY["embed_dim"])
    for name, p in got_params.items():
        got_p, want_p = p.clone(), want_params[name].clone()
        if name.endswith("attn_qkv.bias"):
            got_p[key_third] = want_p[key_third] = 0.0
        rel = float((got_p - want_p).norm() / want_p.norm().clamp_min(1e-30))
        assert rel < 1e-4, (name, rel)
