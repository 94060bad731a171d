"""Tune over the trainer: `Tuner(TorchTrainer(...))` against the reference's
`Tuner(JaxTrainer(...))`, PBT's exploit through a trainer's checkpoint, and
what a stopped trainer-backed trial leaves behind.

The first test trains the tiny GPT of tests/test_torch_trainer.py (2 layers,
width 64, 4 heads) from the same flax-initialised weights and batch through
both packages' Tune, two learning rates in a grid, three steps each: every
trial's losses agree to 1e-5 relative. The PBT test runs the port alone
(the reference's PBT has no bit-level check to hold it to): the exploited
trial must resume from its source's checkpoint bit for bit. The last tests
stop trainer-backed trials early and check that nothing of their fits is
left running: no runner thread, no worker actor, no live model.
"""

import gc
import hashlib
import threading
import time
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta

import ray_tpu
import ray_tpu_torch
from ray_tpu import tune as ref_tune
from ray_tpu.air.config import RunConfig as RefRunConfig
from ray_tpu.models.gpt import GPT as JaxGPT
from ray_tpu.models.gpt import GPTConfig as JaxGPTConfig
from ray_tpu.models.gpt import cross_entropy_loss as jax_cross_entropy
from ray_tpu.ops.fused_optim import fused_adamw as jax_fused_adamw
from ray_tpu.train import JaxTrainer
from ray_tpu_torch import train
from ray_tpu_torch import tune
from ray_tpu_torch.air import Checkpoint
from ray_tpu_torch.models import GPT, GPTConfig, params_from_flax
from ray_tpu_torch.models.gpt import cross_entropy_loss
from ray_tpu_torch.ops import FusedAdamWState, fused_adamw
from ray_tpu_torch.train import (
    CheckpointConfig,
    RunConfig,
    ScalingConfig,
    TorchBackendConfig,
    TorchTrainer,
)
from ray_tpu_torch.tune.schedulers import PopulationBasedTraining

torch.set_num_threads(1)

CPU = TorchBackendConfig(device="cpu")
TINY = dict(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64, max_seq_len=128)
STEPS = 3
LRS = (1e-3, 3e-3)


@pytest.fixture
def runtime():
    rt = ray_tpu_torch.init(num_cpus=8, num_gpus=0)
    yield rt
    ray_tpu_torch.shutdown()


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def _jax_loop(config):
    """STEPS fused_adamw steps of the flax GPT at the trial's lr."""
    from ray_tpu import train as jax_train

    model = JaxGPT(JaxGPTConfig(**TINY, dtype=jnp.float32, attention_impl="auto"))

    def loss_fn(params, tokens):
        logits = model.apply(params, tokens)
        return jax_cross_entropy(logits[:, :-1], tokens[:, 1:])

    step = jax.jit(jax.value_and_grad(loss_fn))
    params = config["params"]
    opt = jax_fused_adamw(config["lr"])
    state = opt.init(params)
    tokens = jnp.asarray(config["tokens"])
    for i in range(STEPS):
        loss, grads = step(params, tokens)
        params, state = opt.apply(grads, state, params)
        jax_train.report({"loss": float(loss), "step": i})


def _torch_loop(config):
    """The same steps through the port, on the worker's device."""
    device = train.get_device()
    model = GPT(GPTConfig(**TINY, dtype=torch.float32, attention_impl="auto"), device=device)
    model.load_state_dict(train.prepare_params(params_from_flax(config["params"])))
    params = dict(model.named_parameters())
    opt = fused_adamw(config["lr"])
    state = opt.init(params)
    tokens = train.prepare_batch(torch.from_numpy(config["tokens"]).long())
    for i in range(STEPS):
        logits = model(tokens)
        loss = cross_entropy_loss(logits[:, :-1], tokens[:, 1:])
        grads = torch.autograd.grad(loss, list(params.values()))
        _, state = opt.apply(dict(zip(params, grads)), state, params)
        train.report({"loss": float(loss.detach()), "step": i})


def test_tiny_gpt_trials_train_the_same_through_both_tuners(runtime, tmp_path):
    """Tuner over TorchTrainer (device="cpu") and the reference's Tuner over
    JaxTrainer, the tiny GPT from the same flax weights and batch, lr in a
    grid of two under `train_loop_config`: the same trials, and each one's
    three losses within 1e-5 relative (f32, attention_impl="auto": the
    reference op on the CPU on both sides)."""
    cfg = JaxGPTConfig(**TINY, dtype=jnp.float32, attention_impl="reference")
    flax_params = _numpy_tree(
        JaxGPT(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    tokens = np.random.RandomState(5).randint(0, 128, size=(2, 32)).astype(np.int32)
    base = {"params": flax_params, "tokens": tokens}
    space = {"train_loop_config": {"lr": None}}

    ray_tpu.init(num_cpus=8)
    try:
        space["train_loop_config"]["lr"] = ref_tune.grid_search(list(LRS))
        want_grid = ref_tune.Tuner(
            JaxTrainer(_jax_loop, train_loop_config=base,
                       scaling_config=ray_tpu.train.ScalingConfig(num_workers=1)),
            param_space=space,
            tune_config=ref_tune.TuneConfig(metric="loss", mode="min"),
            run_config=RefRunConfig(name="ref", storage_path=str(tmp_path)),
        ).fit()
    finally:
        ray_tpu.shutdown()
    space["train_loop_config"]["lr"] = tune.grid_search(list(LRS))
    tuner = tune.Tuner(
        TorchTrainer(_torch_loop, train_loop_config=base, backend_config=CPU,
                     scaling_config=ScalingConfig(num_workers=1)),
        param_space=space,
        tune_config=tune.TuneConfig(metric="loss", mode="min"),
        run_config=RunConfig(name="port", storage_path=str(tmp_path)),
    )
    got_grid = tuner.fit()

    def losses(grid):
        return {r.config["train_loop_config"]["lr"]:
                [m["loss"] for m in r.metrics_history if "step" in m and not m.get("done")]
                for r in grid}

    assert got_grid.num_errors == want_grid.num_errors == 0
    got, want = losses(got_grid), losses(want_grid)
    assert sorted(got) == sorted(want) == sorted(LRS)
    for lr in LRS:
        assert len(got[lr]) == len(want[lr]) == STEPS
        np.testing.assert_allclose(got[lr], want[lr], rtol=1e-5)
        assert got[lr][-1] < got[lr][0]
    assert got_grid.get_best_result().config["train_loop_config"]["lr"] == max(LRS)
    # Each trial's fit registered its run record under the trial's id.
    reports = tuner._controller.train_run_reports()
    assert sorted(reports) == sorted(t.trial_id for t in tuner._controller.trials)


# -- PBT through a trainer's checkpoint --------------------------------------


PBT_STEPS = 6
PBT_LRS = (1.0, 3e-3)  # one poor (Adam at lr 1 wrecks the model), one good


def _digest(parts: dict) -> str:
    """sha256 over every leaf's bytes, in name order: equal iff bit for bit."""
    h = hashlib.sha256()
    for part in sorted(parts):
        for name in sorted(parts[part]):
            t = parts[part][name].detach().cpu().contiguous()
            h.update(f"{part}/{name}/{t.dtype}/{tuple(t.shape)}".encode())
            h.update(t.view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _pbt_loop(config):
    """The tiny GPT under fused_adamw at the trial's lr. Every step reports
    its loss and a checkpoint of the parameters and both moments (on the
    host), with their digest taken on the worker before they leave it.
    Restored, it loads that state, checks every leaf against the checkpoint
    with torch.equal and reports both digests with its first result."""
    device = train.get_device()
    model = GPT(GPTConfig(**TINY, dtype=torch.float32), device=device, seed=0)
    params = dict(model.named_parameters())
    opt = fused_adamw(config["lr"])
    state = opt.init(params)
    restored = None
    saved = train.get_checkpoint()
    if saved is not None:
        saved = saved.to_dict()
        with torch.no_grad():
            for name, value in train.prepare_params(saved["params"]).items():
                params[name].copy_(value)
        state = FusedAdamWState(count=saved["count"].clone(),
                                mu=train.prepare_params(saved["mu"]),
                                nu=train.prepare_params(saved["nu"]))
        live = {"params": params, "mu": state.mu, "nu": state.nu}
        restored = {
            "from_lr": saved["lr"], "from_step": saved["step"],
            "saved_digest": saved["digest"], "live_digest": _digest(live),
            "equal": all(torch.equal(live[part][k].detach().cpu(), saved[part][k])
                         for part in live for k in params),
        }
    gen = torch.Generator().manual_seed(3)
    tokens = train.prepare_batch(torch.randint(0, 128, (2, 32), generator=gen))
    start = int(state.count)
    for i in range(start, PBT_STEPS):
        logits = model(tokens)
        loss = cross_entropy_loss(logits[:, :-1], tokens[:, 1:])
        grads = torch.autograd.grad(loss, list(params.values()))
        _, state = opt.apply(dict(zip(params, grads)), state, params)
        parts = {"params": {k: p.detach().cpu().clone() for k, p in params.items()},
                 "mu": {k: m.cpu().clone() for k, m in state.mu.items()},
                 "nu": {k: m.cpu().clone() for k, m in state.nu.items()}}
        ckpt = Checkpoint.from_dict({**parts, "count": state.count.clone(), "lr": config["lr"],
                                     "step": i, "digest": _digest(parts)})
        train.report({"loss": float(loss.detach()), "step": i, "lr": config["lr"],
                      "restored": restored if i == start else None},
                     checkpoint=ckpt)


def test_pbt_exploit_resumes_from_the_source_checkpoint_bit_for_bit(runtime, tmp_path):
    """PBT over two TorchTrainer trials (lr 1.0 and 3e-3 in a grid,
    perturbation_interval 2, quantile 0.5): the poor trial is exploited at
    least once; each exploited fit restores the source's parameters and
    both AdamW moments bit for bit (torch.equal on every leaf, and the
    digest taken on the source's worker before the state left it equals
    the digest of the restored live state); the best trial's loss fell."""
    pbt = PopulationBasedTraining(
        metric="loss", mode="min", perturbation_interval=2, quantile_fraction=0.5,
        hyperparam_mutations={"train_loop_config": [{"lr": lr} for lr in PBT_LRS]},
        resample_probability=0.0, seed=0)
    tuner = tune.Tuner(
        TorchTrainer(_pbt_loop, backend_config=CPU, scaling_config=ScalingConfig(num_workers=1),
                     run_config=RunConfig(checkpoint_config=CheckpointConfig(num_to_keep=1))),
        param_space={"train_loop_config": tune.grid_search([{"lr": lr} for lr in PBT_LRS])},
        tune_config=tune.TuneConfig(metric="loss", mode="min", scheduler=pbt),
        run_config=RunConfig(name="pbt", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert grid.num_errors == 0 and len(grid) == 2
    restores = [m["restored"] for r in grid for m in r.metrics_history if m.get("restored")]
    assert restores, "PBT exploited no trial"
    for restored in restores:
        assert restored["equal"] is True, restored
        assert restored["live_digest"] == restored["saved_digest"], restored
    best = grid.get_best_result()
    losses = [m["loss"] for m in best.metrics_history if "loss" in m]
    assert losses[-1] < losses[0]


# -- a stopped trainer-backed trial leaves nothing running -------------------


_MODELS: list = []  # weakrefs to every model the stop test's loops built
_STOPPED: list = []  # the step at which each loop saw StopIteration


def _long_loop(config):
    """A tiny GPT that would train 40 steps, reporting each."""
    model = GPT(GPTConfig(**TINY, dtype=torch.float32), device=train.get_device(), seed=0)
    _MODELS.append(weakref.ref(model))
    params = dict(model.named_parameters())
    opt = fused_adamw(config["lr"])
    state = opt.init(params)
    tokens = train.prepare_batch(torch.randint(0, 128, (2, 16),
                                               generator=torch.Generator().manual_seed(0)))
    for i in range(40):
        loss = cross_entropy_loss(model(tokens)[:, :-1], tokens[:, 1:])
        grads = torch.autograd.grad(loss, list(params.values()))
        _, state = opt.apply(dict(zip(params, grads)), state, params)
        try:
            train.report({"loss": float(loss.detach()), "step": i})
        except StopIteration:
            _STOPPED.append(i)
            raise


def _wait_for(cond, timeout_s: float = 30.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return cond()


def _live_threads() -> list:
    return [t.name for t in threading.enumerate()
            if t.is_alive() and (t.name.startswith("tune-trial-") or t.name == "train-runner")]


def _live_actors(runtime, class_names) -> list:
    return [r.class_name for r in runtime.controller.list_actors()
            if r.class_name in class_names and r.state.value == "ALIVE"]


@pytest.mark.parametrize("how", ["stop_criterion", "asha"])
def test_stopped_trainer_trial_leaves_nothing_running(runtime, tmp_path, how):
    """Trainer-backed trials stopped before their loop ends, by a stop
    criterion (training_iteration 3) or by ASHA (max_t 4): once fit()
    returns, every loop saw its StopIteration, and within a polled deadline
    no trial thread, no worker runner thread, no trial or worker actor and
    no model of theirs is left (the worker's loop is parked one report
    ahead of the trainer when the stop comes; shutdown drains it)."""
    _MODELS.clear()
    _STOPPED.clear()
    kwargs = dict(metric="loss", mode="min", max_concurrent_trials=2)
    stop = None
    if how == "asha":
        kwargs["scheduler"] = tune.ASHAScheduler(max_t=4, grace_period=1, reduction_factor=2)
    else:
        stop = {"training_iteration": 3}
    tuner = tune.Tuner(
        TorchTrainer(_long_loop, backend_config=CPU, scaling_config=ScalingConfig(num_workers=1)),
        param_space={"train_loop_config": {"lr": tune.grid_search([1e-3, 3e-3, 1e-2])}},
        tune_config=tune.TuneConfig(**kwargs),
        run_config=RunConfig(name=how, storage_path=str(tmp_path), stop=stop),
    )
    grid = tuner.fit()
    assert len(grid) == 3 and grid.num_errors == 0
    assert all(r.metrics["training_iteration"] <= 4 for r in grid)
    assert len(_STOPPED) == 3 and len(_MODELS) == 3, (_STOPPED, len(_MODELS))
    assert _wait_for(lambda: not _live_threads()), _live_threads()
    names = ("RayTrainWorker", "_TrialRunner")
    assert _wait_for(lambda: not _live_actors(runtime, names)), _live_actors(runtime, names)

    def models_freed():
        gc.collect()
        return all(ref() is None for ref in _MODELS)

    assert _wait_for(models_freed), [ref() is not None for ref in _MODELS]
