"""The port's multi-agent sampling, offline IO, off-policy estimators, BC,
A2C and APPO against the reference's on the CPU.

Offline files, their readers and the estimators are numpy in both packages:
a directory written by either reads back in the other, row for row, and the
estimates agree bit for bit. The multi-agent runners' forwards are torch
against XLA, so their rows are held with a greedy exploration forward
(argmax of the policy's logits, swapped in for the stochastic one in both
packages) on the same weights: observations, actions, rewards, episode ids
and done flags exactly, the float outputs within a few ulps. The losses of
BC, A2C and APPO, their metrics and every gradient agree within 1e-4 of
each tensor's largest gradient, and a full update by each tensor's change,
as in tests/test_torch_rllib.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu.rllib.algorithms.a2c import A2CConfig as RefA2CConfig
from ray_tpu.rllib.algorithms.a2c import A2CLearner as RefA2CLearner
from ray_tpu.rllib.algorithms.appo import APPOConfig as RefAPPOConfig
from ray_tpu.rllib.algorithms.appo import APPOLearner as RefAPPOLearner
from ray_tpu.rllib.algorithms.bc import BCConfig as RefBCConfig
from ray_tpu.rllib.algorithms.bc import BCLearner as RefBCLearner
from ray_tpu.rllib.algorithms.ppo import PPOConfig as RefPPOConfig
from ray_tpu.rllib.core import rl_module as ref_rl_module
from ray_tpu.rllib.core.rl_module import RLModuleSpec as RefSpec
from ray_tpu.rllib.env import env as ref_env
from ray_tpu.rllib.env import make_env as ref_make_env
from ray_tpu.rllib.evaluation.env_runner import EnvRunner as RefEnvRunner
from ray_tpu.rllib.evaluation import multi_agent_runner as ref_mar
from ray_tpu.rllib import offline as ref_offline
from ray_tpu.rllib.policy.sample_batch import MultiAgentBatch as RefMultiAgentBatch
from ray_tpu.rllib.policy.sample_batch import SampleBatch as RefSampleBatch
from ray_tpu_torch.rllib import offline
from ray_tpu_torch.rllib.algorithms.a2c import A2CConfig, A2CLearner
from ray_tpu_torch.rllib.algorithms.appo import APPOConfig, APPOLearner
from ray_tpu_torch.rllib.algorithms.bc import BCConfig, BCLearner
from ray_tpu_torch.rllib.algorithms.cql import CQLConfig
from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig
from ray_tpu_torch.rllib.algorithms.sac import SACConfig
from ray_tpu_torch.rllib.core import rl_module as port_rl_module
from ray_tpu_torch.rllib.core.learner import to_device_batch
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec, params_from_flax
from ray_tpu_torch.rllib.env import env as port_env
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.evaluation import multi_agent_runner as port_mar
from ray_tpu_torch.rllib.policy.sample_batch import MultiAgentBatch, SampleBatch

GRAD_RTOL = 1e-4  # of the largest |gradient| of the tensor


@pytest.fixture
def runtime():
    ray_tpu_torch.init(num_cpus=4, num_gpus=0)
    yield
    ray_tpu_torch.shutdown()


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close_to_scale(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-12)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rtol * scale, f"{what}: max err {err:.3e} > {rtol} x {scale:.3e}"


def port_as_flax(named):
    out = {}
    for name, t in named:
        layer, kind = name.split(".")
        t = t.detach().numpy()
        out.setdefault(layer, {})["kernel" if kind == "weight" else "bias"] = (
            t.T if kind == "weight" else t)
    return out


# -- offline files ---------------------------------------------------------------


def _logged_batches(n=3, rows=40, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append({
            SampleBatch.OBS: rng.normal(size=(rows, 4)).astype(np.float32),
            SampleBatch.ACTIONS: rng.integers(0, 2, rows),
            SampleBatch.REWARDS: np.ones(rows, np.float32),
            SampleBatch.TERMINATEDS: rng.random(rows) < 0.1,
            SampleBatch.ACTION_LOGP: np.full(rows, np.log(0.5), np.float32),
            SampleBatch.EPS_ID: (np.arange(rows) // 8 + 100 * i).astype(np.int64),
            "pixels": rng.integers(0, 255, (rows, 2, 3), dtype=np.uint8),
        })
    return out


def _write(writer_cls, batch_cls, path, batches, max_file_size_mb=64.0):
    w = writer_cls(str(path), max_file_size_mb=max_file_size_mb)
    for cols in batches:
        w.write(batch_cls(dict(cols)))
    w.close()


def _lines(path):
    out = []
    for f in sorted(os.listdir(path)):
        assert f.startswith("batches-") and f.endswith(".jsonl") and len(f) == 8 + 8 + 6
        with open(os.path.join(path, f)) as fh:
            out += fh.read().splitlines()
    return out


def test_json_files_are_the_reference_format_and_cross_read(tmp_path):
    """The same batches written by each package: the same lines byte for
    byte (base64 columns with dtype and shape, one batch a line, in
    `batches-<hex>.jsonl`); each package reads the other's directory back
    column for column, and `sample_rows` on the same seed draws the same
    rows from either directory (several files: rotated at a tiny size)."""
    batches = _logged_batches()
    _write(offline.JsonWriter, SampleBatch, tmp_path / "port", batches)
    _write(ref_offline.JsonWriter, RefSampleBatch, tmp_path / "ref", batches)
    assert _lines(tmp_path / "port") == _lines(tmp_path / "ref")
    for src in ("port", "ref"):
        for reader_cls in (offline.JsonReader, ref_offline.JsonReader):
            r = reader_cls(str(tmp_path / src), shuffle=False)
            for cols in batches:
                got = r.next()
                assert sorted(got) == sorted(cols)
                for k in cols:
                    np.testing.assert_array_equal(got[k], cols[k])
                    assert got[k].dtype == cols[k].dtype, k
    _write(offline.JsonWriter, SampleBatch, tmp_path / "rot", batches * 3, 1e-6)
    assert len(os.listdir(tmp_path / "rot")) == 9
    for seed in (0, 3):
        a = offline.JsonReader(str(tmp_path / "rot"), seed=seed)
        b = ref_offline.JsonReader(str(tmp_path / "rot"), seed=seed)
        for n in (50, 7, 130):
            x, y = a.sample_rows(n), b.sample_rows(n)
            assert x.count == y.count == n
            for k in y:
                np.testing.assert_array_equal(x[k], y[k])


def test_reference_offline_writer_reader_roundtrip(tmp_path):
    writer = offline.JsonWriter(str(tmp_path))
    for i in range(3):
        writer.write(SampleBatch({"obs": np.full((4, 2), i, np.float32),
                                  "actions": np.full(4, i, np.int64)}))
    writer.close()
    batch = offline.JsonReader(str(tmp_path), shuffle=False, seed=0).sample_rows(10)
    assert batch.count == 10 and batch["obs"].shape == (10, 2)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        offline.JsonReader(str(tmp_path / "empty"))


# -- estimators ---------------------------------------------------------------------


def _bandit_cols(n_eps, behavior_p1, rng):
    actions = (rng.random(n_eps) < behavior_p1).astype(np.int64)
    logp = np.where(actions == 1, np.log(behavior_p1), np.log(1 - behavior_p1)).astype(np.float32)
    return {SampleBatch.OBS: np.zeros((n_eps, 2), np.float32), SampleBatch.ACTIONS: actions,
            SampleBatch.REWARDS: actions.astype(np.float32), SampleBatch.ACTION_LOGP: logp,
            SampleBatch.EPS_ID: np.arange(n_eps, dtype=np.int64)}


def _target_logp(obs, actions):
    return np.where(actions == 1, np.log(0.9), np.log(0.1))


@pytest.mark.parametrize("gamma", [1.0, 0.95])
def test_is_and_wis_match_reference_bit_for_bit(tmp_path, gamma):
    """One-step bandit episodes and multi-step CartPole-like episodes of
    varying length (WIS's per-timestep means over the episodes alive), the
    same logs in both packages: every estimate equal."""
    rng = np.random.default_rng(0)
    bandit = _bandit_cols(2000, 0.5, rng)
    long = _logged_batches(n=2, rows=64, seed=1)
    for cols in [bandit] + long:
        for name in ("ImportanceSampling", "WeightedImportanceSampling"):
            got = getattr(offline, name)(_target_logp, gamma=gamma)
            want = getattr(ref_offline, name)(_target_logp, gamma=gamma)
            got.process(SampleBatch(dict(cols)))
            want.process(RefSampleBatch(dict(cols)))
            assert got.estimate() == want.estimate()
    _write(offline.JsonWriter, SampleBatch, tmp_path, long)
    got = offline.estimate_from_reader(
        offline.WeightedImportanceSampling(_target_logp, gamma=gamma),
        offline.JsonReader(str(tmp_path), seed=1), num_batches=3)
    want = ref_offline.estimate_from_reader(
        ref_offline.WeightedImportanceSampling(_target_logp, gamma=gamma),
        ref_offline.JsonReader(str(tmp_path), seed=1), num_batches=3)
    assert got == want and got["num_episodes"] > 0


def test_reference_estimator_mechanics():
    """tests/test_rllib.py::test_off_policy_estimators_is_wis on the port."""
    batch = SampleBatch(_bandit_cols(4000, 0.5, np.random.default_rng(0)))
    is_est = offline.ImportanceSampling(_target_logp, gamma=1.0)
    is_est.process(batch)
    wis = offline.WeightedImportanceSampling(_target_logp, gamma=1.0)
    wis.process(batch)
    r, w = is_est.estimate(), wis.estimate()
    assert abs(r["v_behavior"] - 0.5) < 0.05 and abs(r["v_target"] - 0.9) < 0.08
    assert abs(w["v_target"] - 0.9) < 0.08 and r["v_gain"] > 1.5
    with pytest.raises(ValueError, match="ACTION_LOGP"):
        offline.ImportanceSampling(_target_logp).process(SampleBatch({"obs": np.zeros(3)}))


# -- learners: BC, A2C, APPO ------------------------------------------------------------


def _learner_pair(kind, env="CartPole-v1", frag=16, envs=4, **training):
    """Reference and port learners of `kind` on the same weights, and a
    train batch sampled by the reference's runner (BC: an expert's rule)."""
    ref_cls, port_cls, Ref, Port = {
        "bc": (RefBCConfig, BCConfig, RefBCLearner, BCLearner),
        "a2c": (RefA2CConfig, A2CConfig, RefA2CLearner, A2CLearner),
        "appo": (RefAPPOConfig, APPOConfig, RefAPPOLearner, APPOLearner),
    }[kind]

    def cfg(cls, runner_cls=None):
        return (cls().environment(env)
                .env_runners(num_envs_per_env_runner=envs, rollout_fragment_length=frag)
                .training(**training).debugging(seed=1))

    ref_cfg, port_cfg = cfg(ref_cls), cfg(port_cls).learners(device="cpu")
    if kind == "bc":
        rng = np.random.default_rng(3)
        obs = rng.normal(0, 0.5, (envs * frag, 4)).astype(np.float32)
        batch = SampleBatch({"obs": obs, "actions": (obs[:, 2] > 0).astype(np.int64)})
    else:
        sampler = ref_cfg if kind == "appo" else cfg(RefPPOConfig)
        batch = RefEnvRunner(sampler).sample()
    ref_env_obj, env_obj = ref_make_env(env), make_env(env)
    ref = Ref(RefSpec(observation_space=ref_env_obj.observation_space,
                      action_space=ref_env_obj.action_space, seed=2), ref_cfg)
    port = Port(RLModuleSpec(observation_space=env_obj.observation_space,
                             action_space=env_obj.action_space, seed=2), port_cfg)
    ref.build()
    port.build()
    port.set_weights(params_from_flax(host(ref.module.params), port.module.net))
    return ref, port, batch


def _compare_loss_and_grads(ref, port, batch):
    dev = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    (loss, metrics), grads = jax.value_and_grad(ref.compute_loss, has_aux=True)(
        ref.module.params, dev, jax.random.PRNGKey(0), ref.extra_train_state)
    got_grads, got = port._loss_and_grads(to_device_batch(batch, "cpu"))
    np.testing.assert_allclose(float(got["total_loss"]), float(loss), rtol=1e-5, atol=1e-6)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    assert sorted(metrics) == sorted(k for k in got if k != "total_loss")
    flat = port_as_flax(zip(port.module.params, got_grads))
    want = host(grads)["params"]
    assert sorted(flat) == sorted(want)
    for layer in want:
        for kind in ("kernel", "bias"):
            close_to_scale(flat[layer][kind], want[layer][kind], GRAD_RTOL, f"{layer}.{kind}")


def _compare_updates(ref, port, before, lr, what):
    """Each tensor's change within 1e-4 relative L2 of the reference's and
    every element within 0.05 x lr (tests/test_torch_rllib.py); a tensor
    the loss does not reach must not move in either."""
    want = host(ref.module.params)["params"]
    got = port_as_flax(port.module.params.items())
    for layer in want:
        for kind in ("kernel", "bias"):
            d_want = want[layer][kind] - before[layer][kind]
            d_got = got[layer][kind] - before[layer][kind]
            name = f"{what} {layer}.{kind}"
            if not d_want.any():  # BC's value head: no gradient, no step
                assert not d_got.any(), name
                continue
            assert np.abs(d_want).max() > 0.5 * lr, name
            rel = np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want)
            assert rel <= 1e-4, f"{name}: relative L2 {rel:.2e}"
            worst = float(np.abs(d_got - d_want).max())
            assert worst <= 0.05 * lr, f"{name}: max err {worst:.2e}"


@pytest.mark.parametrize("kind,training", [
    ("bc", {}), ("a2c", {}), ("appo", {}), ("appo", {"use_kl_loss": True}),
    ("appo", {"clip_param": 0.05})])
def test_loss_and_gradients_match_reference(kind, training):
    ref, port, batch = _learner_pair(kind, **training)
    if kind == "appo":
        # Off-policy behaviour: perturbed logits and log-probs, so the
        # ratio leaves 1 and the clip and the KL term are live.
        rng = np.random.default_rng(0)
        batch[SampleBatch.ACTION_DIST_INPUTS] = (batch[SampleBatch.ACTION_DIST_INPUTS]
                                                 + rng.normal(size=(batch.count, 2)))
        batch[SampleBatch.ACTION_DIST_INPUTS] = batch[SampleBatch.ACTION_DIST_INPUTS].astype(
            np.float32)
        batch[SampleBatch.ACTION_LOGP] = (batch[SampleBatch.ACTION_LOGP]
                                          + rng.normal(scale=0.3, size=batch.count)
                                          ).astype(np.float32)
        assert batch[SampleBatch.TRUNCATEDS].any() or batch[SampleBatch.TERMINATEDS].any()
    _compare_loss_and_grads(ref, port, batch)


def _reference_permutations(ref, n, n_rows, num_epochs):
    _, key = jax.random.split(ref._rng)
    return [np.asarray(jax.random.permutation(k, n)[:n_rows])
            for k in jax.random.split(key, num_epochs)]


@pytest.mark.parametrize("kind,training", [
    ("bc", dict(minibatch_size=32, num_epochs=2, lr=1e-3)),
    ("a2c", dict(minibatch_size=64, num_epochs=1, lr=1e-3)),
    ("appo", dict(minibatch_size=32, num_epochs=2, lr=1e-3, use_kl_loss=True))])
def test_update_matches_reference(kind, training):
    """A full update of each learner: the metrics averaged over its steps
    within 1e-4, each tensor's change by `_compare_updates` (the shuffled
    learners on the reference's row orders)."""
    ref, port, batch = _learner_pair(kind, **training)
    n = batch.count
    mb = training["minibatch_size"]
    if port.shuffle_minibatches:
        orders = _reference_permutations(ref, n, (n // mb) * mb, training["num_epochs"])
        port._epoch_order = lambda n_, rows: torch.from_numpy(orders.pop(0).astype(np.int64))
    before = host(ref.module.params)["params"]
    want, got = ref.update(batch), port.update(batch)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    _compare_updates(ref, port, before, 1e-3, kind)
    assert port._opt_state["count"] == training["num_epochs"] * (n // mb)


def test_bc_learns_from_logged_rollouts(runtime, tmp_path):
    """tests/test_rllib.py::test_bc_learns_from_logged_rollouts on the port:
    PPO tees its rollouts to `output=`; BC clones a deterministic expert
    written in the same format, its NLL far below log(2)."""
    out_dir = str(tmp_path / "rollouts")
    ppo = (PPOConfig().environment("CartPole-v1")
           .env_runners(num_envs_per_env_runner=2, rollout_fragment_length=16)
           .training(train_batch_size=32, minibatch_size=32, num_epochs=1, output=out_dir)
           .learners(device="cpu").debugging(seed=0).build())
    ppo.train()
    ppo.stop()
    logged = offline.JsonReader(out_dir, shuffle=False).next()
    assert logged.count == 32 and SampleBatch.ACTION_LOGP in logged
    expert_dir = str(tmp_path / "expert")
    writer = offline.JsonWriter(expert_dir)
    rng = np.random.default_rng(0)
    for _ in range(20):
        obs = rng.normal(0, 0.5, (64, 4)).astype(np.float32)
        writer.write(SampleBatch({"obs": obs, "actions": (obs[:, 2] > 0).astype(np.int64)}))
    writer.close()
    bc = (BCConfig().environment("CartPole-v1").offline_data(input_=expert_dir)
          .training(train_batch_size=128, lr=3e-3).learners(device="cpu")
          .debugging(seed=0).build())
    first = bc.train()["bc_nll"]
    for _ in range(39):
        last = bc.train()
    assert last["bc_nll"] < 0.3 < first
    assert bc.compute_single_action([0.0, 0.0, 1.0, 0.0]) == 1
    assert bc.compute_single_action([0.0, 0.0, -1.0, 0.0]) == 0
    bc.stop()
    with pytest.raises(ValueError, match="offline data"):
        BCConfig().environment("CartPole-v1").learners(device="cpu").build()


def test_cql_trains_from_sac_logs_and_estimators_read_them(runtime, tmp_path):
    """SAC tees its Pendulum rollouts (fragments of 8) to `output=`; CQL
    trains from them (finite losses and penalty); WIS over the same logs
    with CQL's policy as the target is finite (tests/test_rllib.py's CQL
    and off-policy estimation checks)."""
    out_dir = str(tmp_path / "sac")
    sac = (SACConfig().environment("Pendulum-v1")
           .env_runners(rollout_fragment_length=8)
           .training(train_batch_size=32, num_steps_sampled_before_learning_starts=32)
           .offline_data(output=out_dir).learners(device="cpu").debugging(seed=0).build())
    for _ in range(8):
        sac.train()
    sac.stop()
    cql = (CQLConfig().environment("Pendulum-v1").offline_data(input_=out_dir)
           .training(train_batch_size=32, cql_alpha=0.5).learners(device="cpu")
           .debugging(seed=0).build())
    for _ in range(3):
        result = cql.train()
    for k in ("cql_penalty", "critic_loss", "actor_loss", "alpha_loss"):
        assert np.isfinite(result[k]), k
    module = cql.get_module()

    def target_logp(obs, actions):
        with torch.no_grad():
            mean, log_std = module.net.actor(module.params, torch.from_numpy(obs))
            a = module.unscale(torch.from_numpy(actions))
            raw = torch.atanh(a)
            std = torch.exp(log_std)
            logp = torch.sum(-0.5 * ((raw - mean) / std) ** 2 - log_std
                             - 0.5 * np.log(2 * np.pi), dim=-1)
            return (logp - torch.sum(torch.log(1 - a**2 + 1e-6), dim=-1)).numpy()

    est = offline.estimate_from_reader(
        offline.WeightedImportanceSampling(target_logp),
        offline.JsonReader(out_dir, seed=0), num_batches=4)
    assert est["num_episodes"] > 0 and np.isfinite(est["v_target"])
    cql.stop()


def test_a2c_cartpole_learns(runtime):
    algo = (A2CConfig().environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=8, rollout_fragment_length=32)
            .training(train_batch_size=512, minibatch_size=512, lr=5e-3)
            .learners(device="cpu").debugging(seed=1)).build()
    first, best = None, -float("inf")
    for _ in range(8):
        ret = algo.train().get("episode_return_mean")
        if ret is not None:
            first = ret if first is None else first
            best = max(best, ret)
    algo.stop()
    assert first is not None and best > first + 10, (first, best)


def test_appo_async_training_and_kl_toggle(runtime):
    algo = (APPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=2,
                         rollout_fragment_length=10)
            .training(train_batch_size=40).learners(device="cpu").debugging(seed=0)).build()
    for _ in range(3):
        result = algo.train()
    assert "mean_ratio" in result and result["num_env_steps_sampled_lifetime"] >= 120
    algo.stop()
    algo = (APPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=0, num_envs_per_env_runner=2,
                         rollout_fragment_length=10)
            .training(train_batch_size=20, use_kl_loss=True).learners(device="cpu")).build()
    assert "mean_kl" in algo.train()
    algo.stop()


# -- multi-agent ---------------------------------------------------------------------


def _greedy_forwards(monkeypatch):
    """Swap both packages' stochastic exploration forward for a greedy one
    (argmax of the logits, with the same log-prob / value outputs)."""

    def ref_greedy(self, params, batch, rng):
        pi_out, vf = self.apply(params, batch[SampleBatch.OBS])
        dist = self.dist_cls(pi_out)
        actions = dist.deterministic_sample()
        return {SampleBatch.ACTIONS: actions, SampleBatch.ACTION_LOGP: dist.logp(actions),
                SampleBatch.ACTION_DIST_INPUTS: pi_out, SampleBatch.VF_PREDS: vf}

    def port_greedy(self, params, batch, generator=None):
        pi_out, vf = self.apply(params, batch[SampleBatch.OBS])
        dist = self.dist_cls(pi_out)
        actions = dist.deterministic_sample()
        return {SampleBatch.ACTIONS: actions, SampleBatch.ACTION_LOGP: dist.logp(actions),
                SampleBatch.ACTION_DIST_INPUTS: pi_out, SampleBatch.VF_PREDS: vf}

    monkeypatch.setattr(ref_rl_module.RLModule, "forward_exploration", ref_greedy)
    monkeypatch.setattr(port_rl_module.RLModule, "forward_exploration", port_greedy)


EXACT = (SampleBatch.OBS, SampleBatch.NEXT_OBS, SampleBatch.REWARDS, SampleBatch.EPS_ID,
         SampleBatch.TERMINATEDS, SampleBatch.TRUNCATEDS, SampleBatch.ACTIONS)


def _same_rows(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if k in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=f"{what} {k}")


class _AllDone:
    """Two agents, no per-agent flags: only "__all__" ends the episode, at
    t = 3 (tests/test_rllib.py's regression env)."""

    def __init__(self, box, discrete):
        self.observation_space = box(-1, 1, shape=(2,))
        self.action_space = discrete(2)
        self._t = 0

    def reset(self, *, seed=None):
        self._t = 0
        obs = {"a": np.zeros(2, np.float32), "b": np.full(2, 0.5, np.float32)}
        return obs, {a: {} for a in obs}

    def step(self, actions):
        self._t += 1
        obs = {a: np.full(2, 0.1 * self._t, np.float32) for a in actions}
        rews = {a: 1.0 for a in actions}
        return obs, rews, {"__all__": self._t >= 3}, {"__all__": False}, {a: {} for a in actions}


class _RefAllDoneEnv(_AllDone, ref_env.MultiAgentEnv):
    def __init__(self, cfg=None):
        from ray_tpu.rllib.env.spaces import Box, Discrete

        super().__init__(Box, Discrete)


class _PortAllDoneEnv(_AllDone, port_env.MultiAgentEnv):
    def __init__(self, cfg=None):
        from ray_tpu_torch.rllib.env.spaces import Box, Discrete

        super().__init__(Box, Discrete)


def _register_all_done():
    ref_env.register_env("AllDoneEnvX", _RefAllDoneEnv)
    port_env.register_env("AllDoneEnvX", _PortAllDoneEnv)


@pytest.mark.parametrize("env,env_config,T", [
    ("MultiAgentCartPole", {"num_agents": 3, "max_steps": 10}, 24),
    ("AllDoneEnvX", {}, 8)])
def test_shared_policy_runner_rows_match_reference(monkeypatch, env, env_config, T):
    """MultiAgentEnvRunner at worker index 2, greedy forwards on the same
    weights, three fragments: the same rows (episode ids from
    2 * 1_000_000 + 1 on, every episode's last row done, "__all__"-only ends
    marked on every agent's rows, truncations bootstrapped) as the
    reference's."""
    _greedy_forwards(monkeypatch)
    _register_all_done()

    def cfg(cls):
        return (cls().environment(env, env_config=env_config)
                .env_runners(rollout_fragment_length=T).debugging(seed=4))

    ref = ref_mar.MultiAgentEnvRunner(cfg(RefPPOConfig), worker_index=2)
    port = port_mar.MultiAgentEnvRunner(cfg(PPOConfig).learners(device="cpu"), worker_index=2)
    port.set_weights(params_from_flax(host(ref.module.params), port.module.net))
    for i in range(3):
        want, got = ref.sample(), port.sample()
        _same_rows(got, want, f"fragment {i}")
        eps = np.asarray(got[SampleBatch.EPS_ID])
        assert eps.min() > 2_000_000 and eps.max() < 3_000_000
        done = np.asarray(got[SampleBatch.TERMINATEDS]) | np.asarray(got[SampleBatch.TRUNCATEDS])
        if env == "AllDoneEnvX":
            # Every agent's row of each episode's third step (its obs 0.2
            # after two steps) is done, and no other.
            third = np.isclose(np.asarray(got[SampleBatch.OBS])[:, 0], 0.2)
            assert third.any()
            np.testing.assert_array_equal(done, third)
    assert port.get_metrics() == ref.get_metrics()


def test_per_policy_runner_rows_and_init_seeds_match_reference(monkeypatch):
    """PerPolicyMultiAgentRunner with two policies and a mapping function:
    each policy's module built from seed (seed + worker_index) + 7727 x
    (offset + 1) over the sorted policy ids, in both packages; then, on the
    reference's weights and greedy forwards, the same MultiAgentBatch rows
    per policy and the same env-step count."""
    _greedy_forwards(monkeypatch)

    def mapping(aid, **kw):
        return "even" if int(str(aid)[-1]) % 2 == 0 else "odd"

    def cfg(cls):
        return (cls().environment("MultiAgentCartPole",
                                  env_config={"num_agents": 3, "max_steps": 12})
                .multi_agent(policies=["odd", "even"], policy_mapping_fn=mapping)
                .env_runners(rollout_fragment_length=16).debugging(seed=3))

    ref = ref_mar.PerPolicyMultiAgentRunner(cfg(RefPPOConfig), worker_index=1)
    port = port_mar.PerPolicyMultiAgentRunner(cfg(PPOConfig).learners(device="cpu"),
                                              worker_index=1)
    probe, ref_probe = make_env("MultiAgentCartPole"), ref_make_env("MultiAgentCartPole")
    for offset, pid in enumerate(("even", "odd")):
        seed = 3 + 1 + 7727 * (offset + 1)
        fresh = RLModuleSpec(observation_space=probe.observation_space,
                             action_space=probe.action_space, seed=seed).build()
        assert all(torch.equal(fresh.params[k], v) for k, v in port.modules[pid].params.items())
        ref_fresh = RefSpec(observation_space=ref_probe.observation_space,
                            action_space=ref_probe.action_space, seed=seed).build()
        for a, b in zip(jax.tree_util.tree_leaves(ref_fresh.params),
                        jax.tree_util.tree_leaves(ref.modules[pid].params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert port.module is port.modules["even"]
    port.set_weights({pid: params_from_flax(host(m.params), port.modules[pid].net)
                      for pid, m in ref.modules.items()})
    for i in range(2):
        want, got = ref.sample(), port.sample()
        assert isinstance(got, MultiAgentBatch) and isinstance(want, RefMultiAgentBatch)
        assert sorted(got) == sorted(want) == ["even", "odd"]
        assert got.env_steps() == want.env_steps() == 16
        for pid in want:
            _same_rows(got[pid], want[pid], f"fragment {i} {pid}")
        assert got["even"].count > got["odd"].count


def test_multi_agent_runner_mechanics():
    """tests/test_rllib.py's eps-id and mapping checks on the port, with the
    stochastic forward: rows per agent, distinct episode ids, GAE columns;
    the forward's outputs come to the host once per env step."""
    cfg = (PPOConfig().environment("MultiAgentCartPole",
                                   env_config={"num_agents": 3, "max_steps": 10})
           .env_runners(rollout_fragment_length=8).learners(device="cpu"))
    runner = port_mar.MultiAgentEnvRunner(cfg)
    calls = []
    inner = port_mar._explore
    port_mar._explore = lambda *a: calls.append(1) or inner(*a)
    try:
        batch = runner.sample(8)
    finally:
        port_mar._explore = inner
    assert len(calls) == 8
    assert batch.count >= 16 and SampleBatch.ADVANTAGES in batch
    assert len(set(np.asarray(batch[SampleBatch.EPS_ID]).tolist())) >= 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_mar.MultiAgentEnvRunner(cfg.copy().env_runners(sample_device="cuda"))


def test_multi_agent_shared_and_per_policy_ppo(runtime):
    """tests/test_rllib.py's shared-policy and per-policy PPO on the port:
    both train; per-policy mode keeps one learner per policy with its own
    parameters (distinct from the other's, started from the per-policy
    seeds), the runners get each policy's weights, get_module(pid)."""
    algo = (PPOConfig().environment("MultiAgentCartPole", env_config={"num_agents": 2})
            .env_runners(rollout_fragment_length=32)
            .training(train_batch_size=128, minibatch_size=64, num_epochs=2)
            .learners(device="cpu").debugging(seed=0)).build()
    for _ in range(2):
        result = algo.train()
    assert result["num_env_steps_sampled_lifetime"] >= 2 * 64 and "total_loss" in result
    algo.stop()

    algo = (PPOConfig().environment("MultiAgentCartPole",
                                    env_config={"num_agents": 2, "max_steps": 50})
            .multi_agent(policies=["left", "right"],
                         policy_mapping_fn=lambda aid, **kw: "left" if str(aid).endswith("0")
                         else "right")
            .env_runners(rollout_fragment_length=32)
            .training(train_batch_size=128, minibatch_size=64, num_epochs=2)
            .learners(device="cpu").debugging(seed=7)).build()
    w0 = algo.learner_group.get_weights()
    probe = make_env("MultiAgentCartPole")
    for offset, pid in enumerate(("left", "right")):
        fresh = RLModuleSpec(observation_space=probe.observation_space,
                             action_space=probe.action_space, seed=7 + 7727 * (offset + 1)).build()
        assert all(torch.equal(fresh.params[k], v) for k, v in w0[pid].items())
    result = algo.train()
    assert any(k.startswith("left/") for k in result)
    assert any(k.startswith("right/") for k in result)
    w = algo.learner_group.get_weights()
    assert set(w) == {"left", "right"}
    assert any(not torch.equal(w["left"][k], w["right"][k]) for k in w["left"])
    runner = algo.env_runner_group.local_runner
    assert set(runner.modules) == {"left", "right"}
    for pid in ("left", "right"):
        assert all(torch.equal(runner.modules[pid].params[k], v) for k, v in w[pid].items())
        assert algo.get_module(pid).params.keys() == w[pid].keys()
    assert set(algo.get_module()) == {"left", "right"}
    algo.stop()
