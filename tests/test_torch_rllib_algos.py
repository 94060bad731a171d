"""PPO and IMPALA end to end on the port (device="cpu"), with the reference's
mechanics (tests/test_rllib.py): learning on CartPole, remote runners and
checkpoints, continuous actions, remote learners and their shards, the
observation filter, IMPALA's async pipeline and its sync fallback, the
MinAtar-Breakout path, PPO's one-iteration overlap, Tune over an Algorithm,
and the refusals. The first PPO and IMPALA iterations are also held against
the reference's, both packages on the same weights.
"""

import jax
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.rllib.algorithms.impala import IMPALAConfig as RefIMPALAConfig
from ray_tpu.rllib.algorithms.ppo import PPOConfig as RefPPOConfig
from ray_tpu_torch import tune
from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.rllib.algorithms.impala import IMPALAConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig
from ray_tpu_torch.rllib.core.rl_module import params_from_flax


@pytest.fixture
def runtime():
    """The port's runtime, 4 CPUs (the reference's ray_start_regular)."""
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


def _cpu(config):
    return config.learners(device="cpu")


def _weights_equal(a, b) -> bool:
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


# -- PPO ------------------------------------------------------------------------


def test_ppo_cartpole_learns(runtime):
    config = _cpu(
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_envs_per_env_runner=4, rollout_fragment_length=64)
        .training(train_batch_size=512, minibatch_size=128, num_epochs=6, lr=3e-4)
        .debugging(seed=7)
    )
    algo = config.build()
    first = algo.train()
    last = None
    for _ in range(6):
        last = algo.train()
    assert last["episode_return_mean"] > first["episode_return_mean"]
    assert last["episode_return_mean"] > 40
    learner = algo.learner_group.local_learner
    assert learner.device.type == "cpu"
    assert all(v.device.type == "cpu" for v in learner._opt_state["mu"].values())
    algo.stop()


def test_ppo_remote_runners_and_checkpoint(runtime):
    config = _cpu(
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                     rollout_fragment_length=16)
        .training(train_batch_size=64, minibatch_size=32, num_epochs=1)
        .debugging(seed=3)
    )
    algo = config.build()
    algo.train()
    ckpt = algo.save()
    w_before = algo.learner_group.get_weights()
    state_before = algo.learner_group.get_state()
    algo.train()
    assert not _weights_equal(algo.learner_group.get_weights(), w_before)
    algo.restore(ckpt)
    assert _weights_equal(algo.learner_group.get_weights(), w_before)
    state = algo.learner_group.get_state()
    for moment in ("mu", "nu"):
        assert _weights_equal(state["opt_state"][moment], state_before["opt_state"][moment])
    assert state["opt_state"]["count"] == state_before["opt_state"]["count"]
    # Runners got the restored weights too.
    runner_w = ray_tpu_torch.get(
        algo.env_runner_group.remote_runners()[1].get_weights.remote())
    assert _weights_equal(runner_w, w_before)
    algo.stop()


def test_ppo_pendulum_continuous(runtime):
    config = _cpu(
        PPOConfig()
        .environment("Pendulum-v1")
        .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=32)
        .training(train_batch_size=64, minibatch_size=32, num_epochs=1)
    )
    algo = config.build()
    result = algo.train()
    assert "total_loss" in result and np.isfinite(result["total_loss"])
    action = algo.compute_single_action(np.zeros(3, np.float32))
    assert action.shape == (1,)
    algo.stop()


def test_ppo_remote_learners(runtime):
    config = _cpu(
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=16)
        .training(train_batch_size=32, minibatch_size=16, num_epochs=1)
        .learners(num_learners=2)
    )
    algo = config.build()
    result = algo.train()
    assert "total_loss" in result
    w = [ray_tpu_torch.get(worker.get_weights.remote())
         for worker in algo.learner_group._workers]
    assert _weights_equal(w[0], w[1])  # both applied the same averaged gradient
    algo.stop()


def test_ppo_with_observation_filter(runtime):
    config = _cpu(
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                     rollout_fragment_length=16,
                     observation_filter="MeanStdFilter")
        .training(train_batch_size=64, minibatch_size=32, num_epochs=1)
        .debugging(seed=0)
    )
    algo = config.build()
    algo.train()
    algo.train()
    # Global stat accumulated across remote runners and broadcast.
    local_filter = algo.env_runner_group.local_runner.obs_filter
    assert local_filter is not None and local_filter.stat.count > 0
    act = algo.compute_single_action([0.0, 0.0, 0.0, 0.0])
    assert act in (0, 1)
    algo.stop()


def test_ppo_minatar_breakout_mechanics(runtime):
    config = _cpu(
        PPOConfig()
        .environment("MinAtar-Breakout")
        .env_runners(num_envs_per_env_runner=8, rollout_fragment_length=32)
        .training(train_batch_size=256, minibatch_size=64, num_epochs=2)
        .debugging(seed=0)
    )
    algo = config.build()
    result = None
    for _ in range(2):
        result = algo.train()
    assert result["num_env_steps_sampled_lifetime"] >= 512
    assert "policy_loss" in result
    assert "episode_return_mean" in result or result["episodes_this_iter"] == 0
    algo.stop()


def test_ppo_overlapped_sampling_staleness_bounded(runtime):
    config = _cpu(
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                     rollout_fragment_length=16)
        .training(train_batch_size=128, minibatch_size=64, num_epochs=2)
        .debugging(seed=1)
    )
    algo = config.build()
    for _ in range(3):
        result = algo.train()
    # One pending request per live runner, armed for the NEXT iteration.
    assert set(algo._inflight_samples.keys()) == set(
        algo.env_runner_group.remote_runners().keys()
    )
    assert result["num_env_steps_sampled_lifetime"] >= 3 * 128
    algo.stop()


def test_compute_single_action_explore_uses_the_runner_generator(runtime):
    def actions(seed):
        algo = _cpu(PPOConfig().environment("CartPole-v1").debugging(seed=seed)
                    .env_runners(rollout_fragment_length=8)).build()
        out = [int(algo.compute_single_action([0.0, 0.1, 0.0, -0.1], explore=True))
               for _ in range(24)]
        algo.stop()
        return out

    first, again = actions(5), actions(5)
    assert first == again and set(first) == {0, 1}


# -- IMPALA ------------------------------------------------------------------------


def test_impala_async_training(runtime):
    cfg = _cpu(
        IMPALAConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                     rollout_fragment_length=10)
        .training(train_batch_size=40)
        .debugging(seed=0)
    )
    algo = cfg.build()
    for _ in range(3):
        result = algo.train()
    assert "mean_rho" in result
    assert result["num_env_steps_sampled_lifetime"] >= 120
    algo.stop()


def test_impala_sync_fallback(runtime):
    cfg = _cpu(
        IMPALAConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=0, num_envs_per_env_runner=2,
                     rollout_fragment_length=10)
        .training(train_batch_size=20)
    )
    algo = cfg.build()
    result = algo.train()
    assert "policy_loss" in result
    algo.stop()


def test_impala_aggregator_tree_and_learner_thread(runtime):
    cfg = _cpu(
        IMPALAConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                     rollout_fragment_length=10)
        .training(train_batch_size=40)
    )
    algo = cfg.build()
    assert algo._aggregators, "aggregator actors not created"
    assert algo._learner_thread.is_alive()
    result = None
    for _ in range(3):
        result = algo.train()
    assert result["num_learner_updates"] >= 1
    assert "learner_error" not in result
    assert algo._env_steps_total >= 40
    algo.stop()
    assert not algo._learner_thread.is_alive()


def test_impala_minatar_breakout(runtime):
    cfg = _cpu(
        IMPALAConfig()
        .environment("MinAtar-Breakout")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                     rollout_fragment_length=16)
        .training(train_batch_size=128)
        .debugging(seed=0)
    )
    algo = cfg.build()
    result = None
    for _ in range(3):
        result = algo.train()
    assert result["num_learner_updates"] >= 1
    assert "mean_rho" in result and np.isfinite(result["total_loss"])
    assert algo._env_steps_total >= 256
    algo.stop()


def test_learner_group_slice_unit_alignment(runtime):
    """Remote learner shards land on fragment boundaries (IMPALA): 60 rows
    over 3 learners, 2 fragments each."""
    cfg = _cpu(
        IMPALAConfig()
        .environment("CartPole-v1")
        .env_runners(num_env_runners=2, num_envs_per_env_runner=1,
                     rollout_fragment_length=10)
        .training(train_batch_size=60)
        .learners(num_learners=3, num_cpus_per_learner=0)
    )
    algo = cfg.build()
    result = algo.train()
    assert "policy_loss" in result
    algo.stop()


def test_learner_group_no_empty_shards(runtime):
    """More learners than fragments: extra learners get no shard rather than
    an empty batch (NaN-poisoned gradients)."""
    cfg = _cpu(
        IMPALAConfig()
        .environment("CartPole-v1")
        .env_runners(num_envs_per_env_runner=1, rollout_fragment_length=10)
        .training(train_batch_size=20)  # 2 fragments
        .learners(num_learners=3, num_cpus_per_learner=0)
    )
    algo = cfg.build()
    result = algo.train()
    assert np.isfinite(result["total_loss"])
    algo.stop()


# -- both packages on the same weights ------------------------------------------------


@pytest.mark.parametrize("algo_name", ["ppo", "impala"])
def test_first_iteration_matches_reference(runtime, algo_name):
    """Local sampling (the numpy path in both) on the reference's initial
    weights: the first train() samples the same batch, so its one-step
    update's metrics agree within 1e-4 (torch against XLA float32) and the
    episode statistics exactly."""
    port_cls, ref_cls = {"ppo": (PPOConfig, RefPPOConfig),
                         "impala": (IMPALAConfig, RefIMPALAConfig)}[algo_name]

    def cfg(cls):
        return (cls().environment("CartPole-v1")
                .env_runners(num_envs_per_env_runner=4, rollout_fragment_length=32)
                .training(train_batch_size=128, minibatch_size=128, num_epochs=1, lr=1e-3)
                .debugging(seed=2))

    ray_tpu.init(num_cpus=2)
    try:
        ref = cfg(ref_cls).build()
        port = _cpu(cfg(port_cls)).build()
        weights = params_from_flax(
            jax.tree_util.tree_map(np.asarray, ref.learner_group.get_weights()),
            port.learner_group.local_learner.module.net)
        port.learner_group.set_weights(weights)
        port.env_runner_group.sync_weights(port.learner_group.get_weights())
        want, got = ref.train(), port.train()
        ref.stop()
    finally:
        ray_tpu.shutdown()
    port.stop()
    for k in ("episodes_this_iter", "num_env_steps_sampled_lifetime", "episode_return_mean",
              "episode_len_mean"):
        assert got[k] == want[k], k
    for k in ("total_loss", "policy_loss", "vf_loss", "entropy", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


# -- Tune -------------------------------------------------------------------------------


def test_tuner_runs_ppo_for_two_iterations(runtime, tmp_path):
    space = _cpu(
        PPOConfig()
        .environment("CartPole-v1")
        .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=16)
        .training(train_batch_size=32, minibatch_size=16, num_epochs=1)
    ).to_dict()
    space["lr"] = tune.grid_search([1e-4, 1e-3])
    tuner = tune.Tuner(
        PPO, param_space=space,
        tune_config=tune.TuneConfig(metric="total_loss", mode="min"),
        run_config=RunConfig(name="ppo", storage_path=str(tmp_path),
                             stop={"training_iteration": 2}),
    )
    grid = tuner.fit()
    assert len(grid) == 2
    for result in grid:
        assert not result.error
        assert result.metrics["training_iteration"] == 2
        assert result.metrics["num_env_steps_sampled_lifetime"] == 64
    assert sorted(r.config["lr"] for r in grid) == [1e-4, 1e-3]


# -- refusals ---------------------------------------------------------------------------


def test_refusals():
    if not torch.cuda.is_available():
        # The learner defaults to the card; without it the build raises.
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PPOConfig().environment("CartPole-v1").build()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            IMPALAConfig().environment("MinAtar-Breakout").build()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _cpu(PPOConfig().environment("CartPole-v1")
                 .env_runners(sample_device="cuda")).build()
    with pytest.raises(NotImplementedError, match="§B9"):
        PPOConfig().multi_agent(policies={"a", "b"})
    with pytest.raises(NotImplementedError, match="§B9"):
        PPOConfig().offline_data(output="/nowhere")
    with pytest.raises(NotImplementedError, match="§B9"):
        _cpu(PPOConfig().environment("MultiAgentCartPole")).build()
    with pytest.raises(NotImplementedError, match="§B9"):
        _cpu(PPOConfig().environment("CartPole-v1").training(policies={"a": None})).build()
    from ray_tpu_torch.rllib.core.learner import Learner

    with pytest.raises(NotImplementedError, match="§B7"):
        Learner(None, None, mesh=object())
