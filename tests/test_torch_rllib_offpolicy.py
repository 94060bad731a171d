"""The port's off-policy RLlib against the reference's on the CPU:
exploration schedules and noise, replay buffers, n-step transitions, DQN,
Ape-X, SAC, TD3 and CQL.

The same seeded numpy inputs and the reference's flax weights go through
both packages. What is numpy in both (schedules, noise on host arrays,
replay sampling and priorities, n-step rewriting) must agree bit for bit.
Each loss is a pure function of its noise in the port, so the port is given
the reference's own draws (made here from the same key splits as the
reference's loss): loss, metrics and every gradient then agree within
1e-4 of each tensor's largest gradient (torch's and XLA's float32 products
and sums, a few ulps apart). A full update is compared by each tensor's
change (`_compare_updates`). Rollouts with exploration noise cannot match
bit for bit; they are held to the greedy limits and to counts.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.rllib.algorithms.cql.cql import CQLConfig as RefCQLConfig
from ray_tpu.rllib.algorithms.cql.cql import CQLLearner as RefCQLLearner
from ray_tpu.rllib.algorithms.dqn.dqn import DQNConfig as RefDQNConfig
from ray_tpu.rllib.algorithms.dqn.dqn import DQNLearner as RefDQNLearner
from ray_tpu.rllib.algorithms.dqn.dqn import DQNModule as RefDQNModule
from ray_tpu.rllib.algorithms.dqn.dqn import n_step_transitions as ref_n_step
from ray_tpu.rllib.algorithms.sac.sac import SACConfig as RefSACConfig
from ray_tpu.rllib.algorithms.sac.sac import SACLearner as RefSACLearner
from ray_tpu.rllib.algorithms.sac.sac import SACModule as RefSACModule
from ray_tpu.rllib.algorithms.td3.td3 import TD3Config as RefTD3Config
from ray_tpu.rllib.algorithms.td3.td3 import TD3Learner as RefTD3Learner
from ray_tpu.rllib.algorithms.td3.td3 import TD3Module as RefTD3Module
from ray_tpu.rllib.core.rl_module import RLModuleSpec as RefSpec
from ray_tpu.rllib.env.spaces import Box as RefBox
from ray_tpu.rllib.env.spaces import Discrete as RefDiscrete
from ray_tpu.rllib.evaluation.env_runner import EnvRunner as RefEnvRunner
from ray_tpu.rllib.policy.sample_batch import SampleBatch as RefSampleBatch
from ray_tpu.rllib.utils import exploration as ref_exploration
from ray_tpu.rllib.utils import replay_buffers as ref_replay
from ray_tpu_torch.rllib.algorithms.apex_dqn import ApexDQNConfig, ReplayShard
from ray_tpu_torch.rllib.algorithms.cql import CQLConfig, CQLLearner
from ray_tpu_torch.rllib.algorithms.dqn import DQNConfig, DQNLearner, DQNModule
from ray_tpu_torch.rllib.algorithms.dqn.dqn import n_step_transitions
from ray_tpu_torch.rllib.algorithms.sac import SACConfig, SACLearner, SACModule
from ray_tpu_torch.rllib.algorithms.td3 import TD3Config, TD3Learner, TD3Module
from ray_tpu_torch.rllib.core.learner import to_device_batch
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec, params_from_flax
from ray_tpu_torch.rllib.env.spaces import Box, Discrete
from ray_tpu_torch.rllib.evaluation.env_runner import EnvRunner
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch
from ray_tpu_torch.rllib.utils import exploration, replay_buffers

GRAD_RTOL = 1e-4  # of the largest |gradient| of the tensor
METRIC_RTOL = 1e-4
HIDDENS = (32, 32)


@pytest.fixture
def runtime():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat_flax(tree, prefix=""):
    """A flax tree as {"a/b/kernel": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_flax(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def flat_port(named):
    """Port tensors by name ("pi.fc_0.weight", "log_alpha") keyed like
    `flat_flax` of the reference's tree, weights transposed to kernels."""
    out = {}
    for name, t in named:
        t = t.detach().cpu().numpy()
        *path, kind = name.split(".")
        if not path:
            out[kind] = t
            continue
        key = "/".join(path)
        out[f"{key}/kernel" if kind == "weight" else f"{key}/bias"] = t.T if kind == "weight" else t
    return out


def close_to_scale(got, want, rtol, what="", floor=0.0):
    """Every element within rtol of the tensor's largest magnitude (or of
    `floor`, where that is larger)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), floor, 1e-12)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rtol * scale, f"{what}: max err {err:.3e} > {rtol} x {scale:.3e}"


# -- exploration -------------------------------------------------------------


def test_schedules_match_reference():
    for t in (0, 1, 50, 99, 100, 101, 5000, 10_000, 20_000):
        for kind in ("linear", "exponential"):
            want = ref_exploration.EpsilonGreedy(0.9, 0.02, 100, kind)
            got = exploration.EpsilonGreedy(0.9, 0.02, 100, kind)
            assert got.epsilon(t) == want.epsilon(t)
            a, b = got.inputs(t)["epsilon"], want.inputs(t)["epsilon"]
            assert a == b and a.dtype == b.dtype == np.float32
        assert (exploration.LinearSchedule(1.0, 0.1, 100).value(t)
                == ref_exploration.LinearSchedule(1.0, 0.1, 100).value(t))
        assert (exploration.ExponentialSchedule(1.0, 0.1, 100, 0.5).value(t)
                == ref_exploration.ExponentialSchedule(1.0, 0.1, 100, 0.5).value(t))
        assert (exploration.GaussianNoise(0.5, 0.1, 100).inputs(t)
                == ref_exploration.GaussianNoise(0.5, 0.1, 100).inputs(t))


def test_host_noise_matches_reference_bit_for_bit():
    acts = np.linspace(-1, 1, 24, dtype=np.float32).reshape(8, 3)
    for clip in (None, 0.7):
        got = exploration.GaussianNoise(0.5, 0.1, 10, clip=clip)
        want = ref_exploration.GaussianNoise(0.5, 0.1, 10, clip=clip)
        r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
        for t in (0, 5, 30):
            a, b = got.apply(acts, t, r1), want.apply(acts, t, r2)
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype == np.float32
    got, want = exploration.OrnsteinUhlenbeckNoise(), ref_exploration.OrnsteinUhlenbeckNoise()
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    for step in range(6):
        if step == 3:
            got.reset()
            want.reset()
        np.testing.assert_array_equal(got.apply(acts, r1), want.apply(acts, r2))


def test_reference_exploration_mechanics():
    """tests/test_rllib.py::test_exploration_schedules on the port."""
    lin = exploration.LinearSchedule(1.0, 0.1, 100)
    assert lin.value(0) == 1.0
    assert abs(lin.value(50) - 0.55) < 1e-9
    eg = exploration.EpsilonGreedy(1.0, 0.05, 200)
    assert abs(eg.epsilon(10_000) - 0.05) < 1e-9
    gn = exploration.GaussianNoise(initial_scale=0.5, final_scale=0.1, scale_timesteps=10,
                                   clip=1.0)
    noisy = gn.apply(np.zeros((64,), np.float32), 0, np.random.default_rng(0))
    assert np.abs(noisy).max() <= 1.0 and noisy.std() > 0.2
    eg = exploration.EpsilonGreedy(0.9, 0.1, 100, schedule="exponential")
    assert abs(eg.epsilon(100) - max(0.1, 0.9 * 0.1)) < 1e-9


# -- replay ---------------------------------------------------------------------


def _rows(rng, n, start=0):
    return {
        SampleBatch.OBS: rng.normal(size=(n, 4)).astype(np.float32),
        SampleBatch.ACTIONS: rng.integers(0, 2, n),
        SampleBatch.REWARDS: np.arange(start, start + n, dtype=np.float32),
        SampleBatch.TERMINATEDS: rng.random(n) < 0.1,
    }


@pytest.mark.parametrize("prioritized", [False, True])
def test_replay_sampling_and_priorities_match_reference_bit_for_bit(prioritized):
    """The same adds (wrapping the ring twice), samples and priority
    updates: every sampled column, the importance weights and the indexes
    equal bit for bit, from numpy's default_rng(seed) in both."""
    if prioritized:
        got = replay_buffers.PrioritizedReplayBuffer(100, alpha=0.7, beta=0.5, seed=3)
        want = ref_replay.PrioritizedReplayBuffer(100, alpha=0.7, beta=0.5, seed=3)
    else:
        got = replay_buffers.ReplayBuffer(100, seed=3)
        want = ref_replay.ReplayBuffer(100, seed=3)
    rng = np.random.default_rng(0)
    for step in range(9):
        cols = _rows(rng, 30, start=30 * step)
        got.add(SampleBatch(cols))
        want.add(RefSampleBatch(dict(cols)))
        a, b = got.sample(16), want.sample(16)
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k
        if prioritized:
            td = rng.normal(scale=3.0, size=16)
            got.update_priorities(a["batch_indexes"], td)
            want.update_priorities(b["batch_indexes"], td)
    assert len(got) == len(want) == 100
    assert got.stats() == want.stats()
    if prioritized:
        np.testing.assert_array_equal(got._priorities, want._priorities)
        assert got._max_priority == want._max_priority


def test_reference_replay_mechanics():
    """tests/test_rllib.py's ring and prioritized-replay checks on the port."""
    buf = replay_buffers.ReplayBuffer(capacity=10, seed=0)
    buf.add(SampleBatch({"obs": np.arange(6.0), "rewards": np.arange(6.0)}))
    buf.add(SampleBatch({"obs": np.arange(8.0), "rewards": np.arange(8.0)}))
    assert len(buf) == 10 and buf.sample(32).count == 32 and buf.stats()["num_added"] == 14
    buf = replay_buffers.PrioritizedReplayBuffer(capacity=100, alpha=1.0, beta=1.0, seed=0)
    buf.add(SampleBatch({"obs": np.arange(50.0)}))
    buf.update_priorities(np.array([7]), np.array([1e6]))
    assert np.mean(buf.sample(200)["batch_indexes"] == 7) > 0.9


def test_n_step_transitions_match_reference():
    """A CartPole fragment with several episode ends, n in {1, 2, 3, 5}:
    the rewritten columns equal the reference's bit for bit."""
    from ray_tpu.rllib.algorithms.ppo import PPOConfig as RefPPOConfig

    batch = RefEnvRunner(RefPPOConfig().environment("CartPole-v1", env_config={"max_steps": 7})
                         .env_runners(num_envs_per_env_runner=3,
                                      rollout_fragment_length=20)).sample()
    for n in (1, 2, 3, 5):
        want = ref_n_step(RefSampleBatch(dict(batch)), n, 0.99)
        got = n_step_transitions(SampleBatch(dict(batch)), n, 0.99)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"n={n} {k}")
    got = n_step_transitions(SampleBatch({
        SampleBatch.REWARDS: np.array([1.0, 2.0, 3.0, 4.0], np.float32),
        SampleBatch.TERMINATEDS: np.array([False, False, False, True]),
        SampleBatch.NEXT_OBS: np.arange(4.0, dtype=np.float32)[:, None],
        SampleBatch.EPS_ID: np.zeros(4, np.int64),
    }), n=3, gamma=0.9)
    np.testing.assert_allclose(got[SampleBatch.REWARDS][[0, 2]], [5.23, 6.6], rtol=1e-5)
    assert got[SampleBatch.NEXT_OBS][0, 0] == 2.0 and got[SampleBatch.TERMINATEDS][2]


# -- learners: shared machinery -------------------------------------------------


def _perturbed(tree, seed):
    """A target network near the online one, so target and online differ."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.normal(scale=0.05, size=np.shape(x))).astype(np.float32),
        host(tree))


def _pair(kind, dueling=False, **training):
    """Reference and port learners of `kind` on the same weights, with the
    same (perturbed) target network."""
    obs_dim = 4 if kind == "dqn" else 3
    if kind == "dqn":
        ref_mod, mod, ref_act, act = RefDQNModule, DQNModule, RefDiscrete(3), Discrete(3)
    else:
        ref_mod, mod = {"sac": (RefSACModule, SACModule), "cql": (RefSACModule, SACModule),
                        "td3": (RefTD3Module, TD3Module)}[kind]
        ref_act, act = RefBox(-2.0, 2.0, shape=(2,)), Box(-2.0, 2.0, shape=(2,))
    ref_cls, port_cls, Ref, Port = {
        "dqn": (RefDQNConfig, DQNConfig, RefDQNLearner, DQNLearner),
        "sac": (RefSACConfig, SACConfig, RefSACLearner, SACLearner),
        "td3": (RefTD3Config, TD3Config, RefTD3Learner, TD3Learner),
        "cql": (RefCQLConfig, CQLConfig, RefCQLLearner, CQLLearner),
    }[kind]
    model = {"fcnet_hiddens": HIDDENS, "dueling": dueling}
    ref_cfg = ref_cls().training(**training).debugging(seed=1)
    port_cfg = port_cls().training(**training).debugging(seed=1).learners(device="cpu")
    ref = Ref(RefSpec(module_class=ref_mod, observation_space=RefBox(-1, 1, shape=(obs_dim,)),
                      action_space=ref_act, model_config=model, seed=2), ref_cfg)
    port = Port(RLModuleSpec(module_class=mod, observation_space=Box(-1, 1, shape=(obs_dim,)),
                             action_space=act, model_config=model, seed=2), port_cfg)
    ref.build()
    port.build()
    net = port.module.net
    port.set_weights(params_from_flax(host(ref.module.params), net))
    target = _perturbed(ref.module.params, seed=5)
    ref.extra_train_state = dict(ref.extra_train_state, target=target)
    port.extra_train_state = dict(port.extra_train_state,
                                  target=params_from_flax(target, net))
    if kind == "td3":
        port._pi_snapshot = port._pi_subtree(port.module.params)
    return ref, port


def _batch(kind, n=48, seed=0):
    rng = np.random.default_rng(seed)
    obs_dim = 4 if kind == "dqn" else 3
    cols = {
        SampleBatch.OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
        SampleBatch.NEXT_OBS: rng.normal(size=(n, obs_dim)).astype(np.float32),
        SampleBatch.REWARDS: rng.normal(size=n).astype(np.float32),
        SampleBatch.TERMINATEDS: rng.random(n) < 0.25,
    }
    if kind == "dqn":
        cols[SampleBatch.ACTIONS] = rng.integers(0, 3, n)
    else:
        # Some actions at the bounds exercise unscale's clip to +-0.999.
        acts = rng.uniform(-2.0, 2.0, size=(n, 2)).astype(np.float32)
        acts[:4] = np.float32(2.0)
        cols[SampleBatch.ACTIONS] = acts
    return SampleBatch(cols)


def _reference_noise(kind, key, n, cql_actions=4):
    """The draws the reference's loss makes from `key`, as the port's
    sample_noise returns them."""
    shape = (n, 2)
    if kind == "td3":
        return {"target": torch.from_numpy(np.array(jax.random.normal(key, shape)))}
    if kind == "cql":
        _, key, rng_uni, rng_pi = jax.random.split(key, 4)
    rng_next, rng_pi_sac = jax.random.split(key)
    out = {"next": jax.random.normal(rng_next, shape), "pi": jax.random.normal(rng_pi_sac, shape)}
    if kind == "cql":
        out["uniform"] = jax.random.uniform(rng_uni, (cql_actions,) + shape, minval=-1.0,
                                            maxval=1.0)
        out["policy"] = jnp.stack([jax.random.normal(k, shape)
                                   for k in jax.random.split(rng_pi, cql_actions)])
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def _compare_loss_and_grads(ref, port, batch, noise=None, key=None):
    dev = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    key = jax.random.PRNGKey(11) if key is None else key
    (loss, metrics), grads = jax.value_and_grad(ref.compute_loss, has_aux=True)(
        ref.module.params, dev, key, ref.extra_train_state)
    if noise is not None:
        port.sample_noise = lambda b: noise
    got_grads, got = port._loss_and_grads(to_device_batch(batch, "cpu"))
    np.testing.assert_allclose(float(got["total_loss"]), float(loss), rtol=1e-5, atol=1e-6)
    for k, v in metrics.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v), rtol=METRIC_RTOL,
                                   atol=1e-5, err_msg=k)
    flat = flat_port(zip(port.module.params, got_grads))
    want = flat_flax(host(grads)["params"])
    assert sorted(flat) == sorted(want)
    for name in want:
        # A bias's gradient is a sum over the batch's rows that can cancel
        # (SAC's critic outputs: ~5e-3 from rows of ~1, whose targets carry
        # log(1 - tanh^2 + 1e-6) at saturated actions, ~3e-6 apart in the two
        # libraries): it is held to its layer's largest gradient.
        kernel = want.get(name[: -len("bias")] + "kernel")
        floor = float(np.max(np.abs(kernel))) if name.endswith("/bias") and kernel is not None else 0.0
        close_to_scale(flat[name], want[name], GRAD_RTOL, name, floor=floor)
    return want


def _reference_update_draws(ref, kind, n):
    """The row order and the minibatch key of the reference's next update
    (one epoch, one minibatch of all n rows)."""
    _, key = jax.random.split(ref._rng)
    epoch_key = jax.random.split(key, 1)[0]
    perm = np.asarray(jax.random.permutation(epoch_key, n))
    return perm, _reference_noise(kind, jax.random.fold_in(epoch_key, 0), n)


def _compare_updates(ref, port, before, lr, what, frozen=()):
    """Each tensor's change over the update against the reference's: its
    relative L2 error within 1e-4 and every element within 0.05 x lr (Adam
    amplifies the ulps of the two libraries' gradients where a gradient
    element is ~0, so elements are held to a share of lr; a step of the wrong
    sign or size moves an element by ~lr or more). Tensors whose names start
    with a prefix in `frozen` must not have moved in the reference (the
    caller holds the port's to its own values before, bit for bit)."""
    want = flat_flax(host(ref.module.params)["params"])
    got = flat_port(port.module.params.items())
    assert sorted(got) == sorted(want)
    for name in want:
        d_want, d_got = want[name] - before[name], got[name] - before[name]
        if name.startswith(frozen):
            assert not d_want.any(), f"{what} {name} moved"
            continue
        assert np.abs(d_want).max() > 0.5 * lr, f"{what} {name}"
        rel = np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want)
        assert rel <= 1e-4, f"{what} {name}: relative L2 {rel:.2e}"
        worst = float(np.abs(d_got - d_want).max())
        assert worst <= 0.05 * lr, f"{what} {name}: max err {worst:.2e}"


def _compare_targets(ref, port, what):
    want = flat_flax(host(ref.extra_train_state["target"])["params"])
    got = flat_port(port.extra_train_state["target"].items())
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{what} target {name}")


# -- DQN -----------------------------------------------------------------------


@pytest.mark.parametrize("double_q,dueling,extras", [
    (True, False, False), (False, False, False), (True, True, True), (False, True, True)])
def test_dqn_loss_and_gradients_match_reference(double_q, dueling, extras):
    ref, port = _pair("dqn", dueling=dueling, double_q=double_q)
    batch = _batch("dqn")
    if extras:  # prioritized replay's weights and n-step discounts
        rng = np.random.default_rng(1)
        batch["weights"] = rng.uniform(0.2, 1.0, batch.count).astype(np.float32)
        batch["nstep_discount"] = (0.99 ** rng.integers(1, 4, batch.count)).astype(np.float32)
    _compare_loss_and_grads(ref, port, batch)


def test_dqn_update_matches_reference():
    """Two updates: each tensor's change, the metrics, and the per-sample
    TD errors (one host copy with the metrics); then sync_target copies the
    online weights into the target on the learner's device."""
    ref, port = _pair("dqn", dueling=True, lr=1e-3)
    for i in range(2):
        batch = _batch("dqn", seed=i)
        batch["weights"] = np.linspace(0.3, 1.0, batch.count, dtype=np.float32)
        before = flat_flax(host(ref.module.params)["params"])
        want, got = ref.update(batch), port.update(batch)
        assert sorted(got) == sorted(want)
        td_want, td_got = want.pop("td_error_per_sample"), got.pop("td_error_per_sample")
        assert td_got.shape == (batch.count,) and td_got.dtype == td_want.dtype
        np.testing.assert_allclose(td_got, td_want, rtol=1e-5, atol=1e-5)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, atol=1e-6, err_msg=k)
        _compare_updates(ref, port, before, 1e-3, f"dqn update {i}")
    ref.sync_target()
    port.sync_target()
    _compare_targets(ref, port, "dqn")
    for k, v in port.module.params.items():
        assert torch.equal(port.extra_train_state["target"][k], v.detach())
        assert port.extra_train_state["target"][k].data_ptr() != v.data_ptr()


def _dqn_runners(epsilon, envs=8):
    def spec(cls, module, box, disc):
        return cls(module_class=module, observation_space=box(-1, 1, shape=(4,)),
                   action_space=disc(2), seed=4,
                   model_config={"fcnet_hiddens": HIDDENS, "epsilon_initial": epsilon,
                                 "epsilon_final": epsilon})

    def cfg(cls):
        return (cls().environment("CartPole-v1")
                .env_runners(num_envs_per_env_runner=envs, rollout_fragment_length=32)
                .debugging(seed=5))

    ref_cfg = cfg(RefDQNConfig).rl_module(rl_module_spec=spec(RefSpec, RefDQNModule, RefBox,
                                                               RefDiscrete))
    port_cfg = cfg(DQNConfig).rl_module(rl_module_spec=spec(RLModuleSpec, DQNModule, Box,
                                                             Discrete)).learners(device="cpu")
    ref, port = RefEnvRunner(ref_cfg), EnvRunner(port_cfg)
    assert port._np_explore is None  # DQNModule runs its torch forward
    port.set_weights(params_from_flax(host(ref.module.params), port.module.net))
    return ref, port


def test_dqn_epsilon_greedy_rollouts_at_the_greedy_limits():
    """epsilon = 0: the same CartPole rollouts as the reference (greedy
    actions on the same weights); epsilon = 1: uniform actions, held by
    counts (2 x 4096 draws, within 4.5 sigma of half)."""
    ref, port = _dqn_runners(0.0)
    for _ in range(2):
        want, got = ref.sample(), port.sample()
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    _, port = _dqn_runners(1.0, envs=64)
    actions = np.concatenate([port.sample()[SampleBatch.ACTIONS] for _ in range(2)])
    n = actions.size
    assert n == 4096 and set(np.unique(actions)) == {0, 1}
    assert abs(actions.mean() - 0.5) < 4.5 * 0.5 / np.sqrt(n)


def test_dqn_cartpole_mechanics(runtime):
    """tests/test_rllib.py::test_dqn_cartpole_mechanics (+ the checkpoint
    round trip, which brings the target back to the learner's device)."""
    algo = (DQNConfig().environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=8)
            .training(train_batch_size=16, num_steps_sampled_before_learning_starts=32,
                      target_network_update_freq=64,
                      replay_buffer_config={"type": "prioritized", "capacity": 1000})
            .learners(device="cpu").debugging(seed=0)).build()
    buf = algo.replay_buffer
    for _ in range(6):
        result = algo.train()
    assert result["replay_buffer_size"] > 32 and "td_error_abs" in result
    assert buf._max_priority != 1.0  # priorities moved by the TD errors
    ckpt = algo.save()
    algo.restore(ckpt)
    learner = algo.learner_group.local_learner
    assert all(v.device.type == "cpu" for v in learner.extra_train_state["target"].values())
    algo.train()
    assert algo.compute_single_action([0.0, 0.0, 0.0, 0.0], explore=True) in (0, 1)
    algo.stop()


def test_dqn_dueling_head_and_shared_schedule(runtime):
    algo = (DQNConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=2,
                         rollout_fragment_length=8)
            .training(train_batch_size=32, num_steps_sampled_before_learning_starts=16,
                      model={"dueling": True, "fcnet_hiddens": (32, 32)})
            .learners(device="cpu")).build()
    result = algo.train()
    assert "num_env_steps_sampled_lifetime" in result
    weights = algo.learner_group.get_weights()
    assert "value_head.weight" in weights and "advantage_head.weight" in weights
    module = algo.env_runner_group.local_runner.module
    assert module.exploration_inputs(0)["epsilon"] == pytest.approx(1.0)
    assert module.exploration_inputs(5000)["epsilon"] == pytest.approx(0.525)
    algo.stop()


# -- Ape-X ------------------------------------------------------------------------


def _actor_threads(handles) -> set:
    names = {f"actor-{h._actor_id.hex()[:8]}" for h in handles}
    return {t.name for t in threading.enumerate()} & names


def test_apex_dqn_mechanics_and_stop(runtime):
    """tests/test_rllib.py::test_apex_dqn_mechanics on the port: every shard
    fills round-robin, priorities return to the serving shard, training
    metrics flow; then stop() kills every shard (no actor thread left) and
    drops every pending push, prefetch and priority update."""
    cfg = (ApexDQNConfig().environment("CartPole-v1")
           .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=8)
           .training(train_batch_size=16, num_steps_sampled_before_learning_starts=32,
                     target_network_update_freq=64)
           .learners(device="cpu").debugging(seed=0))
    cfg.num_replay_shards = 3
    algo = cfg.build()
    shards = list(algo.replay_shards)
    assert len(shards) == 3 and algo.replay_buffer is None
    for _ in range(8):
        result = algo.train()
    sizes = [ray_tpu_torch.get(s.size.remote()) for s in shards]
    assert all(size > 0 for size in sizes), sizes
    assert "td_error_abs" in result and result["replay_shards"] == 3
    # Priorities came back: a shard's importance weights are no longer all 1.
    weights = [ray_tpu_torch.get(s.sample.remote(16))["weights"] for s in shards]
    assert any(float(w.min()) < 1.0 for w in weights)
    assert algo._prefetched is not None
    assert _actor_threads(shards) == {f"actor-{s._actor_id.hex()[:8]}" for s in shards}
    algo.stop()
    deadline = time.monotonic() + 10.0
    while _actor_threads(shards) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not _actor_threads(shards)
    assert (algo.replay_shards, algo._inflight_pushes, algo._inflight_prio,
            algo._prefetched) == ([], [], [], None)


def test_replay_shard_matches_a_local_prioritized_buffer():
    """A shard is the reference's: its prioritized buffer samples and takes
    priority updates (|td| + 1e-6, as the reference's shard adds) as a local
    buffer on the same seed does."""
    shard = ReplayShard(64, 0.6, 0.4, 7)
    local = ref_replay.PrioritizedReplayBuffer(64, alpha=0.6, beta=0.4, seed=7)
    rng = np.random.default_rng(2)
    assert shard.sample(8) is None
    for _ in range(3):
        cols = _rows(rng, 24)
        shard.add(SampleBatch(cols))
        local.add(RefSampleBatch(dict(cols)))
        a, b = shard.sample(8), local.sample(8)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        td = rng.normal(size=8)
        shard.update_priorities(a["batch_indexes"], td)
        local.update_priorities(b["batch_indexes"], np.abs(td) + 1e-6)
    assert shard.size() == len(local) == 64


# -- SAC, TD3, CQL ---------------------------------------------------------------------


def test_params_from_flax_carries_sac_and_td3_trees():
    """SAC's tree (pi / q1 / q2 of fc_i and out, the scalar log_alpha) and
    TD3's map onto the port's nets, and the forwards then agree."""
    obs = np.random.default_rng(3).normal(size=(9, 3)).astype(np.float32)
    for kind in ("sac", "td3"):
        ref, port = _pair(kind)
        names = set(port.module.params)
        assert {"pi.fc_0.weight", "pi.out.bias", "q1.fc_1.weight", "q2.out.weight"} <= names
        assert ("log_alpha" in names) == (kind == "sac")
        want = flat_flax(host(ref.module.params)["params"])
        got = flat_port(port.module.params.items())
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        w = ref.module.forward_inference(ref.module.params, {SampleBatch.OBS: jnp.asarray(obs)})
        with torch.no_grad():
            g = port.module.forward_inference(port.module.params,
                                              {SampleBatch.OBS: torch.from_numpy(obs)})
        np.testing.assert_allclose(g[SampleBatch.ACTIONS].numpy(),
                                   np.asarray(w[SampleBatch.ACTIONS]), rtol=2e-5, atol=1e-6)
        assert np.abs(g[SampleBatch.ACTIONS].numpy()).max() <= 2.0


@pytest.mark.parametrize("kind", ["sac", "td3", "cql"])
def test_continuous_losses_and_gradients_match_reference(kind):
    ref, port = _pair(kind)
    batch = _batch(kind)
    key = jax.random.PRNGKey(11)
    noise = _reference_noise(kind, key, batch.count)
    want = _compare_loss_and_grads(ref, port, batch, noise=noise, key=key)
    if kind != "td3":
        # alpha_loss reaches log_alpha only; the actor term reaches pi only
        # through the sampled action.
        assert want["log_alpha"] != 0.0
    if kind == "td3":
        ref.extra_train_state["step"] = jnp.ones((), jnp.int32)
        port.extra_train_state["step"] = 1
        want = _compare_loss_and_grads(ref, port, batch, noise=noise, key=key)
        assert not any(want[k].any() for k in want if k.startswith("pi/"))


@pytest.mark.parametrize("kind", ["sac", "cql"])
def test_sac_family_update_matches_reference_with_polyak_targets(kind):
    """Two full updates from the same state, each on the reference's row
    order and noise: each tensor's change (log_alpha included) and the
    Polyak-averaged targets."""
    ref, port = _pair(kind, lr=1e-3, tau=0.05)
    for i in range(2):
        batch = _batch(kind, seed=10 + i)
        perm, noise = _reference_update_draws(ref, kind, batch.count)
        port._epoch_order = lambda n, rows, p=perm: torch.from_numpy(p.astype(np.int64))
        port.sample_noise = lambda b, z=noise: z
        before = flat_flax(host(ref.module.params)["params"])
        want, got = ref.update(batch), port.update(batch)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, atol=1e-6,
                                       err_msg=k)
        _compare_updates(ref, port, before, 1e-3, f"{kind} update {i}")
        _compare_targets(ref, port, kind)
    assert port._opt_state["count"] == 2


def test_td3_update_matches_reference_across_two_ticks():
    """Update 0 (a delay tick): the actor and the target move. Update 1
    (an off tick): the actor's gradient is zero but Adam's moments still
    step it; it is reverted to its snapshot, bit for bit, while its moments
    keep moving, and the target stays. Both held against the reference."""
    ref, port = _pair("td3", lr=1e-3, tau=0.05)
    for i in range(2):
        batch = _batch("td3", seed=20 + i)
        perm, noise = _reference_update_draws(ref, "td3", batch.count)
        port._epoch_order = lambda n, rows, p=perm: torch.from_numpy(p.astype(np.int64))
        port.sample_noise = lambda b, z=noise: z
        before = flat_flax(host(ref.module.params)["params"])
        pi_before = {k: v.detach().clone() for k, v in port.module.params.items()
                     if k.startswith("pi.")}
        mu_before = {k: v.clone() for k, v in port._opt_state["mu"].items()}
        target_before = {k: v.clone() for k, v in port.extra_train_state["target"].items()}
        want, got = ref.update(batch), port.update(batch)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, atol=1e-6,
                                       err_msg=k)
        _compare_updates(ref, port, before, 1e-3, f"td3 update {i}",
                         frozen=("pi/",) if i == 1 else ())
        _compare_targets(ref, port, "td3")
        assert port.extra_train_state["step"] == int(ref.extra_train_state["step"]) == i + 1
        if i == 1:
            for k, v in pi_before.items():
                assert torch.equal(port.module.params[k].detach(), v), k
                assert not torch.equal(port._opt_state["mu"][k], mu_before[k]), k
            for k, v in target_before.items():
                assert torch.equal(port.extra_train_state["target"][k], v), k


def test_sac_module_forwards_and_exploration():
    """tests/test_rllib.py::test_sac_module_forwards on the port: explored
    actions inside the bounds, their log-probs finite; a seeded generator
    repeats its draws."""
    mod = SACModule(Box(-1.0, 1.0, shape=(3,)), Box(-2.0, 2.0, shape=(1,)))
    batch = {SampleBatch.OBS: torch.zeros((4, 3))}
    with torch.no_grad():
        out = mod.forward_exploration(mod.params, batch, torch.Generator().manual_seed(0))
        again = mod.forward_exploration(mod.params, batch, torch.Generator().manual_seed(0))
        det = mod.forward_inference(mod.params, batch)[SampleBatch.ACTIONS]
    acts = out[SampleBatch.ACTIONS].numpy()
    assert acts.shape == (4, 1) and np.all(np.abs(acts) <= 2.0)
    assert torch.equal(out[SampleBatch.ACTIONS], again[SampleBatch.ACTIONS])
    assert torch.isfinite(out[SampleBatch.ACTION_LOGP]).all() and det.shape == (4, 1)


def test_sac_pendulum_mechanics(runtime):
    algo = (SACConfig().environment("Pendulum-v1")
            .env_runners(num_envs_per_env_runner=1, rollout_fragment_length=8)
            .training(train_batch_size=32, num_steps_sampled_before_learning_starts=32,
                      training_intensity=0.25)
            .learners(device="cpu").debugging(seed=0)).build()
    for _ in range(8):
        result = algo.train()
    assert "critic_loss" in result and result["alpha"] > 0 and result["alpha"] != 1.0
    ckpt = algo.save()
    algo.restore(ckpt)
    act = algo.compute_single_action([0.1, 0.2, 0.0])
    assert -2.0 <= float(act[0]) <= 2.0
    algo.stop()


def test_td3_pendulum_mechanics(runtime):
    algo = (TD3Config().environment("Pendulum-v1")
            .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=8)
            .training(train_batch_size=64, num_steps_sampled_before_learning_starts=32)
            .learners(device="cpu").debugging(seed=0)).build()
    for _ in range(6):
        result = algo.train()
    assert "critic_loss" in result and "mean_q" in result
    act = algo.compute_single_action(np.zeros((3,), np.float32), explore=True)
    assert act.shape == (1,) and -2.0 <= float(act[0]) <= 2.0
    learner = algo.learner_group.local_learner
    assert learner.extra_train_state["step"] == 5  # one update an iteration from the 2nd
    algo.stop()
