"""ray_tpu_torch.rllib against the reference's RLlib (ray_tpu.rllib) on the CPU.

The same seeded numpy inputs go through both packages; the reference's flax
parameters cross into the port with `params_from_flax`. What is numpy in
both (the environments, the numpy rollout path, GAE) must agree exactly;
what runs in torch against XLA (the forwards, the losses, their gradients,
Adam) agrees within the tolerances stated at each test: float32 products
summed in a different order by two libraries differ by a few units in the
last place per product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rllib.algorithms.impala import IMPALAConfig as RefIMPALAConfig
from ray_tpu.rllib.algorithms.impala import IMPALALearner as RefIMPALALearner
from ray_tpu.rllib.algorithms.impala import vtrace as ref_vtrace
from ray_tpu.rllib.algorithms.ppo import PPOConfig as RefPPOConfig
from ray_tpu.rllib.algorithms.ppo import PPOLearner as RefPPOLearner
from ray_tpu.rllib.core import distributions as ref_dist
from ray_tpu.rllib.core.rl_module import PiVfNet as RefPiVfNet
from ray_tpu.rllib.core.rl_module import RLModuleSpec as RefSpec
from ray_tpu.rllib.env import make_env as ref_make_env
from ray_tpu.rllib.env import make_vector_env as ref_make_vector_env
from ray_tpu.rllib.evaluation.env_runner import EnvRunner as RefEnvRunner
from ray_tpu_torch.rllib.algorithms.impala import IMPALAConfig, IMPALALearner, vtrace
from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig, PPOLearner
from ray_tpu_torch.rllib.core import distributions as port_dist
from ray_tpu_torch.rllib.core.learner import to_device_batch
from ray_tpu_torch.rllib.core.rl_module import PiVfNet, RLModuleSpec, params_from_flax
from ray_tpu_torch.rllib.env import make_env, make_vector_env
from ray_tpu_torch.rllib.evaluation.env_runner import EnvRunner
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch

# Forwards, losses and gradients: torch's and XLA's float32 products and
# sums, each a few ulps apart, through two or three layers.
FWD_RTOL, FWD_ATOL = 2e-5, 1e-6
GRAD_RTOL = 1e-4  # of the largest |gradient| of the tensor


def host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close_to_scale(got, want, rtol, what=""):
    """Every element within rtol of the tensor's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-12)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rtol * scale, f"{what}: max err {err:.3e} > {rtol} x {scale:.3e}"


def port_grads_as_flax(names, grads):
    """Port gradients (name -> [out, in] weight / bias) keyed like flax."""
    out = {}
    for name, g in zip(names, grads):
        layer, kind = name.split(".")
        g = g.detach().numpy()
        out.setdefault(layer, {})["kernel" if kind == "weight" else "bias"] = (
            g.T if kind == "weight" else g)
    return out


# -- environments ---------------------------------------------------------


@pytest.mark.parametrize("name,config", [
    ("CartPole-v1", {"max_steps": 30}),
    ("Pendulum-v1", {"max_steps": 25}),
    ("MinAtar-Breakout", {}),
])
def test_envs_step_identically(name, config):
    ref, port = ref_make_env(name, config), make_env(name, config)
    rng = np.random.default_rng(0)
    o_r, _ = ref.reset(seed=3)
    o_p, _ = port.reset(seed=3)
    np.testing.assert_array_equal(o_p, o_r)
    dones = 0
    for _ in range(120):
        a = port.action_space.sample(rng)
        r1, r2 = ref.step(a), port.step(a)
        for x, y in zip(r2[:4], r1[:4]):
            np.testing.assert_array_equal(x, y)
        if r1[2] or r1[3]:
            dones += 1
            o_r, _ = ref.reset()
            o_p, _ = port.reset()
            np.testing.assert_array_equal(o_p, o_r)
    assert dones >= 1


@pytest.mark.parametrize("name", ["CartPole-v1", "MinAtar-Breakout", "Pendulum-v1"])
def test_vector_envs_step_identically(name):
    cfg = {"max_steps": 20}
    ref, port = ref_make_vector_env(name, 5, cfg), make_vector_env(name, 5, cfg)
    assert type(port).__name__ == type(ref).__name__
    o_r, _ = ref.reset(seed=11)
    o_p, _ = port.reset(seed=11)
    np.testing.assert_array_equal(o_p, o_r)
    rng = np.random.default_rng(1)
    finals = 0
    for _ in range(60):
        a = np.stack([port.action_space.sample(rng) for _ in range(5)])
        r1, r2 = ref.step(a), port.step(a)
        for x, y in zip(r2[:4], r1[:4]):
            np.testing.assert_array_equal(x, y)
        for i1, i2 in zip(r1[4], r2[4]):
            assert ("final_observation" in i1) == ("final_observation" in i2)
            if "final_observation" in i1:
                finals += 1
                np.testing.assert_array_equal(i2["final_observation"], i1["final_observation"])
    assert finals >= 1


# -- distributions ----------------------------------------------------------


def test_categorical_matches_reference():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(64, 6)).astype(np.float32), rng.normal(size=(64, 6)).astype(np.float32)
    actions = rng.integers(0, 6, 64)
    r, r2 = ref_dist.Categorical(jnp.asarray(a)), ref_dist.Categorical(jnp.asarray(b))
    p, p2 = port_dist.Categorical(torch.from_numpy(a)), port_dist.Categorical(torch.from_numpy(b))
    np.testing.assert_allclose(p.logp(torch.from_numpy(actions)).numpy(),
                               r.logp(jnp.asarray(actions)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p.entropy().numpy(), r.entropy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p.kl(p2).numpy(), r.kl(r2), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(p.deterministic_sample().numpy(), r.deterministic_sample())
    draws = p.sample(torch.Generator().manual_seed(0))
    assert draws.shape == (64,) and int(draws.min()) >= 0 and int(draws.max()) < 6


def test_diag_gaussian_matches_reference():
    rng = np.random.default_rng(1)
    # Some log_std beyond [-20, 2], so the clip is exercised.
    a = np.concatenate([rng.normal(size=(32, 3)), rng.normal(scale=8, size=(32, 3))], 1)
    b = np.concatenate([rng.normal(size=(32, 3)), rng.normal(size=(32, 3))], 1)
    a, b = a.astype(np.float32), b.astype(np.float32)
    x = rng.normal(size=(32, 3)).astype(np.float32)
    r, r2 = ref_dist.DiagGaussian(jnp.asarray(a)), ref_dist.DiagGaussian(jnp.asarray(b))
    p, p2 = port_dist.DiagGaussian(torch.from_numpy(a)), port_dist.DiagGaussian(torch.from_numpy(b))
    np.testing.assert_allclose(p.logp(torch.from_numpy(x)).numpy(), r.logp(jnp.asarray(x)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p.entropy().numpy(), r.entropy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(p.kl(p2).numpy(), r.kl(r2), rtol=1e-5, atol=1e-5)
    assert p.sample(torch.Generator().manual_seed(0)).shape == (32, 3)


# -- the module -------------------------------------------------------------


def _module_pair(env: str, seed: int = 0, model=None):
    """The reference's RLModule and the port's with the reference's weights."""
    env_obj, ref_env = make_env(env), ref_make_env(env)
    spec_args = dict(model_config=model or {}, seed=seed)
    ref = RefSpec(observation_space=ref_env.observation_space,
                  action_space=ref_env.action_space, **spec_args).build()
    port = RLModuleSpec(observation_space=env_obj.observation_space,
                        action_space=env_obj.action_space, **spec_args).build()
    port.set_state(params_from_flax(host(ref.params), port.net))
    return ref, port


@pytest.mark.parametrize("env,model", [
    ("CartPole-v1", None),
    ("Pendulum-v1", None),
    ("MinAtar-Breakout", {"fcnet_hiddens": (64, 32), "fcnet_activation": "relu"}),
    ("CartPole-v1", {"vf_share_layers": True, "fcnet_activation": "swish"}),
])
def test_rl_module_forwards_match_reference(env, model):
    ref, port = _module_pair(env, seed=4, model=model)
    shape = tuple(make_env(env).observation_space.shape)
    obs = np.random.default_rng(2).normal(size=(33,) + shape).astype(np.float32)
    want = ref.forward_train(ref.params, {SampleBatch.OBS: jnp.asarray(obs)})
    with torch.no_grad():
        got = port.forward_train(port.params, {SampleBatch.OBS: torch.from_numpy(obs)})
    for k in (SampleBatch.ACTION_DIST_INPUTS, SampleBatch.VF_PREDS):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=FWD_RTOL, atol=FWD_ATOL)
    want = ref.forward_inference(ref.params, {SampleBatch.OBS: jnp.asarray(obs)})
    with torch.no_grad():
        got = port.forward_inference(port.params, {SampleBatch.OBS: torch.from_numpy(obs)})
    np.testing.assert_allclose(got[SampleBatch.ACTIONS].numpy(),
                               np.asarray(want[SampleBatch.ACTIONS]), rtol=FWD_RTOL,
                               atol=FWD_ATOL)


def test_pi_vf_net_init_statistics_match_flax():
    """The port draws its own numbers, from flax's distributions: every
    kernel a normal truncated at 2 sigma of variance scale/fan_in (scale
    0.01 for pi_head), every bias 0. Held layer by layer against flax's
    draw: standard deviations within 6%, the same truncation bound."""
    in_dim, hiddens = 96, (256, 128)
    ref_net = RefPiVfNet(action_dim=8, hiddens=hiddens)
    ref_params = host(ref_net.init(jax.random.PRNGKey(0), jnp.zeros((1, in_dim))))["params"]
    net = PiVfNet(in_dim, 8, hiddens=hiddens, generator=torch.Generator().manual_seed(0))
    torch_default = torch.nn.Linear(in_dim, hiddens[0]).weight.detach().numpy()
    for name, child in net.named_children():
        w = child.weight.detach().numpy().T
        k = ref_params[name]["kernel"]
        assert w.shape == k.shape, name
        fan_in = w.shape[0]
        sigma = np.sqrt((0.01 if name == "pi_head" else 1.0) / fan_in) / 0.87962566103423978
        assert np.abs(w).max() <= 2 * sigma * (1 + 1e-6), name
        assert np.abs(k).max() <= 2 * sigma * (1 + 1e-6), name
        assert abs(w.std() / k.std() - 1) < 0.06, (name, w.std(), k.std())
        assert abs(w.mean()) < 4 * k.std() / np.sqrt(w.size), name
        assert not child.bias.detach().numpy().any() and not ref_params[name]["bias"].any()
    # torch's default (kaiming uniform) would be a different distribution.
    assert abs(torch_default.std() / ref_params["pi_0"]["kernel"].std() - 1) > 0.3


# -- the env runner's numpy path -----------------------------------------------


@pytest.mark.parametrize("env,env_config,filt", [
    ("CartPole-v1", {"max_steps": 9}, None),
    ("Pendulum-v1", {"max_steps": 13}, None),
    ("CartPole-v1", {"max_steps": 40}, "MeanStdFilter"),
    ("MinAtar-Breakout", {}, None),
])
def test_env_runner_numpy_path_gives_the_same_batch(env, env_config, filt):
    """Column by column and bit for bit: actions, eps_id and dones, and
    every float column (the numpy forward is the reference's on the same
    contiguous weights, so the products are the same BLAS calls), GAE's
    advantages and targets, VALUES_BOOTSTRAPPED at truncations and at the
    fragment cut, NEXT_OBS at auto-resets."""

    def cfg(cls):
        c = (cls().environment(env, env_config=env_config)
             .env_runners(num_envs_per_env_runner=3, rollout_fragment_length=16)
             .debugging(seed=5))
        if filt:
            c = c.env_runners(observation_filter=filt)
        return c

    ref = RefEnvRunner(cfg(RefPPOConfig), worker_index=2)
    port = EnvRunner(cfg(PPOConfig).learners(device="cpu"), worker_index=2)
    assert port._np_explore is not None
    port.set_weights(params_from_flax(host(ref.module.params), port.module.net))
    truncated_rows = 0
    for _ in range(3):
        want, got = ref.sample(), port.sample()
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].dtype == want[k].dtype, k
        truncated_rows += int(np.asarray(want[SampleBatch.TRUNCATEDS]).sum())
    if env_config.get("max_steps", 1000) < 16:
        assert truncated_rows > 0
    assert got[SampleBatch.ADVANTAGES].shape == (48,)
    m1, m2 = ref.get_metrics(), port.get_metrics()
    assert m1 == m2


# -- V-trace -----------------------------------------------------------------------


def test_vtrace_matches_reference_with_dones_and_clipping():
    rng = np.random.default_rng(3)
    T, B, gamma = 12, 5, 0.97
    log_rhos = rng.normal(scale=1.2, size=(T, B)).astype(np.float32)  # rho beyond 1 and 0.5
    done = rng.random((T, B)) < 0.2
    discounts = (gamma * (1.0 - done)).astype(np.float32)
    rewards = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T, B)).astype(np.float32)
    boot = rng.normal(size=(B,)).astype(np.float32)
    for rho_clip, pg_clip in ((1.0, 1.0), (0.5, 2.0)):
        want = ref_vtrace.from_importance_weights(
            *(jnp.asarray(x) for x in (log_rhos, discounts, rewards, values, boot)),
            clip_rho_threshold=rho_clip, clip_pg_rho_threshold=pg_clip)
        got = vtrace.from_importance_weights(
            *(torch.from_numpy(x) for x in (log_rhos, discounts, rewards, values, boot)),
            clip_rho_threshold=rho_clip, clip_pg_rho_threshold=pg_clip)
        np.testing.assert_allclose(got.vs.numpy(), want.vs, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.pg_advantages.numpy(), want.pg_advantages,
                                   rtol=1e-5, atol=1e-5)
    assert (np.exp(log_rhos) > 2.0).any() and done.any()


def test_vtrace_outputs_carry_no_gradient():
    values = torch.randn(4, 2, requires_grad=True)
    out = vtrace.from_importance_weights(torch.zeros(4, 2), torch.full((4, 2), 0.9),
                                         torch.ones(4, 2), values, torch.zeros(2))
    assert not out.vs.requires_grad and not out.pg_advantages.requires_grad


# -- learners ------------------------------------------------------------------------


def _learner_pair(kind, env="CartPole-v1", frag=16, envs=4, **training):
    """Reference and port learners of `kind` with the same weights, and a
    train batch sampled by the reference's runner."""
    ref_cls, port_cls, Ref, Port = {
        "ppo": (RefPPOConfig, PPOConfig, RefPPOLearner, PPOLearner),
        "impala": (RefIMPALAConfig, IMPALAConfig, RefIMPALALearner, IMPALALearner),
    }[kind]

    def cfg(cls):
        return (cls().environment(env)
                .env_runners(num_envs_per_env_runner=envs, rollout_fragment_length=frag)
                .training(**training).debugging(seed=1))

    ref_cfg, port_cfg = cfg(ref_cls), cfg(port_cls).learners(device="cpu")
    runner = RefEnvRunner(ref_cfg)
    batch = runner.sample()
    obs_space, act_space = runner.spaces()
    ref = Ref(RefSpec(observation_space=obs_space, action_space=act_space, seed=2), ref_cfg)
    env_obj = make_env(env)
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
    np.testing.assert_allclose(float(got["total_loss"]), float(loss), rtol=1e-5)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    flat = port_grads_as_flax(list(port.module.params), got_grads)
    want = host(grads)["params"]
    assert sorted(flat) == sorted(want)
    for layer in want:
        for kind in ("kernel", "bias"):
            close_to_scale(flat[layer][kind], want[layer][kind], GRAD_RTOL, f"{layer}.{kind}")


def test_ppo_loss_and_gradients_match_reference():
    ref, port, batch = _learner_pair("ppo", entropy_coeff=0.01)
    _compare_loss_and_grads(ref, port, batch)


def test_ppo_loss_and_gradients_match_reference_continuous():
    ref, port, batch = _learner_pair("ppo", env="Pendulum-v1")
    _compare_loss_and_grads(ref, port, batch)


def test_impala_loss_and_gradients_match_reference():
    ref, port, batch = _learner_pair("impala", frag=16)
    assert batch[SampleBatch.TRUNCATEDS].any() or batch[SampleBatch.TERMINATEDS].any()
    _compare_loss_and_grads(ref, port, batch)


def _reference_permutations(ref, n, n_rows, num_epochs):
    """The row orders the reference's scanned update draws from its key."""
    _, key = jax.random.split(ref._rng)
    return [np.asarray(jax.random.permutation(k, n)[:n_rows])
            for k in jax.random.split(key, num_epochs)]


def _compare_updates(ref, port, before, lr, what):
    """Each tensor's change over the update against the reference's: its
    relative L2 error within 1e-4 (measured: at most 2.7e-5), and every
    element within 0.05 x lr (measured: at most 0.017 x lr, on elements
    whose gradient is ~0, where Adam's m / sqrt(v) amplifies the ulps of the
    two libraries' gradients). A step of the wrong sign or size moves an
    element by ~lr or more, and a wrong bias correction scales every step."""
    want = host(ref.module.params)["params"]
    got = port_grads_as_flax(list(port.module.params), list(port.module.params.values()))
    for layer in want:
        for kind in ("kernel", "bias"):
            d_want = want[layer][kind] - before[layer][kind]
            d_got = got[layer][kind] - before[layer][kind]
            name = f"{what} {layer}.{kind}"
            assert np.abs(d_want).max() > 0.5 * lr, name
            rel = np.linalg.norm(d_got - d_want) / np.linalg.norm(d_want)
            assert rel <= 1e-4, f"{name}: relative L2 {rel:.2e}"
            worst = float(np.abs(d_got - d_want).max())
            assert worst <= 0.05 * lr, f"{name}: max err {worst:.2e}"


def test_ppo_update_matches_reference():
    """2 epochs x 4 minibatches (n = 144, so 16 rows drop each epoch),
    the port's epoch orders replaced by the reference's permutations. The
    eight Adam steps at lr 1e-3 move every tensor; each tensor's change
    must agree with the reference's (`_compare_updates`), the averaged
    metrics to 1e-4."""
    ref, port, batch = _learner_pair("ppo", frag=36, envs=4, minibatch_size=32,
                                     num_epochs=2, lr=1e-3, entropy_coeff=0.01)
    n = batch.count
    assert n == 144
    orders = _reference_permutations(ref, n, 128, 2)
    port._epoch_order = lambda n_, rows: torch.from_numpy(orders.pop(0).astype(np.int64))
    before = host(ref.module.params)["params"]
    want = ref.update(batch)
    got = port.update(batch)
    assert not orders
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    _compare_updates(ref, port, before, 1e-3, "ppo")
    assert port._opt_state["count"] == 8


def test_impala_update_matches_reference_with_the_clip_firing():
    """One IMPALA update over 4 fragments of 16 in 2 epochs of 2 in-order
    minibatches of 2 fragments, with grad_clip 0.05, far below the
    gradient's norm, so optax's `(g / norm) * clip` runs at every step (an
    update without the clip moves pi_0 12% away in relative L2)."""
    ref, port, batch = _learner_pair("impala", frag=16, envs=4, grad_clip=0.05, lr=1e-3,
                                     minibatch_size=32, num_epochs=2)
    before = host(ref.module.params)["params"]
    want = ref.update(batch)
    got = port.update(batch)
    assert want["grad_norm"] > 10 * 0.05
    assert port._opt_state["count"] == 4
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    _compare_updates(ref, port, before, 1e-3, "impala")


def test_ppo_kl_coefficient_is_frozen_per_update_shape_as_in_the_reference():
    """ROADMAP §D18, kept for parity: `_kl_coeff` adapts (one update late),
    but the loss keeps the coefficient in force at that update shape's first
    update. The batch's ACTION_DIST_INPUTS are perturbed so mean_kl is far
    above 2 x kl_target; each update is one step over the whole batch, so
    the loss's coefficient is (total - policy - vf_coeff x vf) / mean_kl."""
    ref, port, batch = _learner_pair("ppo", minibatch_size=64, num_epochs=1,
                                     kl_target=1e-6, lr=1e-4)
    assert batch.count == 64
    rng = np.random.default_rng(0)
    batch[SampleBatch.ACTION_DIST_INPUTS] = (
        batch[SampleBatch.ACTION_DIST_INPUTS] + rng.normal(size=(64, 2)).astype(np.float32))
    coeffs = {"ref": [], "port": []}
    effective = {"ref": [], "port": []}
    for _ in range(4):
        for name, learner in (("ref", ref), ("port", port)):
            m = learner.update(batch)
            coeffs[name].append(learner._kl_coeff)
            assert m["mean_kl"] > 0.01
            effective[name].append(
                (m["total_loss"] - m["policy_loss"] - 1.0 * m["vf_loss"]) / m["mean_kl"])
    np.testing.assert_allclose(coeffs["ref"], [0.2, 0.3, 0.45, 0.675], rtol=1e-12)
    np.testing.assert_allclose(coeffs["port"], coeffs["ref"], rtol=1e-12)
    np.testing.assert_allclose(effective["ref"], 0.2, rtol=1e-3)
    np.testing.assert_allclose(effective["port"], 0.2, rtol=1e-3)
    # A new update shape traces (reference) / freezes (port) the coefficient
    # in force then.
    half = batch.slice(0, 32)
    for name, learner in (("ref", ref), ("port", port)):
        m = learner.update(half)
        effective[name].append(
            (m["total_loss"] - m["policy_loss"] - m["vf_loss"]) / m["mean_kl"])
    np.testing.assert_allclose(effective["port"][-1], effective["ref"][-1], rtol=1e-3)
    np.testing.assert_allclose(effective["port"][-1], 0.675, rtol=1e-3)


def test_learner_state_round_trips_on_host_copies():
    _, port, batch = _learner_pair("ppo", minibatch_size=32, num_epochs=1)
    port.update(batch)
    state = port.get_state()
    assert all(v.device.type == "cpu" for v in state["weights"].values())
    assert state["opt_state"]["count"] == 2
    port.update(batch)
    port.set_state(state)
    for k, v in port.module.params.items():
        assert torch.equal(v.detach(), state["weights"][k])
        assert torch.equal(port._opt_state["mu"][k], state["opt_state"]["mu"][k])
    assert port._opt_state["count"] == 2


def test_learner_refuses_a_mesh_and_a_missing_card():
    spec = RLModuleSpec(observation_space=make_env("CartPole-v1").observation_space,
                        action_space=make_env("CartPole-v1").action_space)
    with pytest.raises(NotImplementedError, match="§B7"):
        PPOLearner(spec, PPOConfig(), mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PPOLearner(spec, PPOConfig()).build()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            EnvRunner(PPOConfig().environment("CartPole-v1").env_runners(sample_device="cuda"))
