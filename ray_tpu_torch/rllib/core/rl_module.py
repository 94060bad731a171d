"""RLModule — the neural-network holder of the new stack, in torch.

Reference: rllib/core/rl_module/rl_module.py (RLModule, SingleAgentRLModuleSpec)
and marl_module.py (MultiAgentRLModule). An RLModule owns an `nn.Module` and
its parameters (`params`, a name -> tensor dict on the module's device) and
exposes the three forward passes: `forward_inference` (deterministic
serving), `forward_exploration` (sampling rollouts), `forward_train` (loss
inputs). Each takes the parameters as an argument (`torch.func
.functional_call`), so the Learner differentiates a loss written over
`params` exactly as the JAX package's does.

Initialisation follows flax's distributions, not torch's defaults: kernels
lecun-normal (a normal truncated at two standard deviations, variance
1/fan_in), biases zero, and the policy head at variance 0.01/fan_in.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.rllib.core.distributions import dist_input_dim, get_dist_cls
from ray_tpu_torch.rllib.env.spaces import Space
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch

# flax's variance_scaling(..., "truncated_normal"): the standard deviation of
# a unit normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978
_ACTIVATIONS = {"tanh": torch.tanh, "relu": F.relu, "swish": F.silu}


def _np_logsumexp(x: np.ndarray) -> np.ndarray:
    m = np.max(x, axis=-1, keepdims=True)
    return m + np.log(np.sum(np.exp(x - m), axis=-1, keepdims=True))


def _dense(in_dim: int, out_dim: int, scale: float = 1.0,
           generator: Optional[torch.Generator] = None) -> nn.Linear:
    """nn.Linear initialised as flax's Dense with
    variance_scaling(scale, "fan_in", "truncated_normal") and zero bias."""
    layer = torch.nn.utils.skip_init(nn.Linear, in_dim, out_dim)
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
        layer.weight.mul_(math.sqrt(scale / in_dim) / _TRUNC_STD)
        layer.bias.zero_()
    return layer


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class PiVfNet(nn.Module):
    """Default model: shared or separate MLP encoders + pi / vf heads
    (reference: core/models/catalog.py:28 default MLP encoder + heads).
    Layers carry the flax module's names (pi_0, ..., vf_0, ..., pi_head,
    vf_head) so `params_from_flax` maps one onto the other."""

    def __init__(
        self,
        in_dim: int,
        action_dim: int,
        hiddens: tuple = (256, 256),
        activation: str = "tanh",
        vf_share_layers: bool = False,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.in_dim = int(in_dim)
        self.action_dim = int(action_dim)
        self.hiddens = tuple(hiddens)
        self.activation = activation
        self.vf_share_layers = bool(vf_share_layers)
        self.dtype = dtype
        # flax initialises in call order: the pi tower, the vf tower, pi_head,
        # vf_head; the same order draws from `generator` here.
        for name in ("pi",) if self.vf_share_layers else ("pi", "vf"):
            width = self.in_dim
            for i, out in enumerate(self.hiddens):
                self.add_module(f"{name}_{i}", _dense(width, out, generator=generator))
                width = out
        width = self.hiddens[-1] if self.hiddens else self.in_dim
        # Small-init final layers stabilize early PPO updates.
        self.pi_head = _dense(width, self.action_dim, scale=0.01, generator=generator)
        self.vf_head = _dense(width, 1, generator=generator)

    def _encoder(self, x, name):
        act = _ACTIVATIONS[self.activation]
        for i in range(len(self.hiddens)):
            x = act(_linear(x, getattr(self, f"{name}_{i}"), self.dtype))
        return x

    def forward(self, obs):
        obs = obs.reshape(obs.shape[0], -1)
        z_pi = self._encoder(obs, "pi")
        z_vf = z_pi if self.vf_share_layers else self._encoder(obs, "vf")
        pi_out = _linear(z_pi, self.pi_head, self.dtype)
        vf_out = _linear(z_vf, self.vf_head, self.dtype)
        return pi_out, vf_out[..., 0]


class QNet(nn.Module):
    """Q(s, ·) head for value-based algorithms (DQN).

    dueling=True splits the torso into V(s) + A(s, ·) streams recombined as
    Q = V + A - mean(A) (Wang et al. 2016; reference:
    rllib dqn catalog's dueling head)."""

    def __init__(
        self,
        in_dim: int,
        num_actions: int,
        hiddens: tuple = (256, 256),
        dtype: torch.dtype = torch.float32,
        dueling: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.in_dim = int(in_dim)
        self.num_actions = int(num_actions)
        self.hiddens = tuple(hiddens)
        self.dtype = dtype
        self.dueling = bool(dueling)
        width = self.in_dim
        for i, out in enumerate(self.hiddens):
            self.add_module(f"q_{i}", _dense(width, out, generator=generator))
            width = out
        if self.dueling:
            self.value_head = _dense(width, 1, generator=generator)
            self.advantage_head = _dense(width, self.num_actions, generator=generator)
        else:
            self.q_head = _dense(width, self.num_actions, generator=generator)

    def forward(self, obs):
        x = obs.reshape(obs.shape[0], -1)
        for i in range(len(self.hiddens)):
            x = F.relu(_linear(x, getattr(self, f"q_{i}"), self.dtype))
        if not self.dueling:
            return _linear(x, self.q_head, self.dtype)
        value = _linear(x, self.value_head, self.dtype)
        adv = _linear(x, self.advantage_head, self.dtype)
        return value + adv - torch.mean(adv, dim=-1, keepdim=True)


def params_from_flax(flax_params: Mapping, net: nn.Module) -> dict:
    """The JAX package's parameters of a net as `net`'s state dict: every
    Dense `kernel [in, out]` becomes `weight [out, in]`, `bias` stays, and a
    Dense nested in a submodule (SAC's and TD3's `pi.fc_0`, `q1.out`, ...)
    is found down the same path of flax's tree; a bare parameter of the net
    (SAC's scalar `log_alpha`) is copied as it is. `flax_params` is the
    module's `params` (with or without the top-level "params" key), as
    numpy or JAX arrays."""
    p = flax_params.get("params", flax_params)
    out = {}
    for path, child in net.named_modules():
        if isinstance(child, nn.Linear):
            layer = p
            for part in path.split("."):
                layer = layer[part]
            out[f"{path}.weight"] = torch.from_numpy(
                np.array(layer["kernel"], dtype=np.float32).T.copy())
            out[f"{path}.bias"] = torch.from_numpy(np.array(layer["bias"], dtype=np.float32))
    for name, param in net.named_parameters(recurse=False):
        out[name] = torch.from_numpy(
            np.array(p[name], dtype=np.float32).reshape(tuple(param.shape)))
    missing = set(net.state_dict()) - set(out)
    if missing:
        raise KeyError(f"flax parameters lack {sorted(missing)}")
    return out


class RLModule:
    """Holds an nn.Module + its parameters; forward passes take `params`.

    The module lives on `device` (the CPU unless the caller names another):
    a runner's on its sampling device, a learner's on the learner's."""

    def __init__(
        self,
        observation_space: Space,
        action_space: Space,
        model_config: Optional[dict] = None,
        net: Optional[nn.Module] = None,
        seed: int = 0,
        device: Any = "cpu",
    ):
        self.observation_space = observation_space
        self.action_space = action_space
        self.model_config = dict(model_config or {})
        self.dist_cls = get_dist_cls(action_space)
        if net is None:
            net = PiVfNet(
                # The width of the flattened observation, as flax's dummy input.
                in_dim=int(np.prod(observation_space.shape)),
                action_dim=dist_input_dim(action_space),
                hiddens=tuple(self.model_config.get("fcnet_hiddens", (256, 256))),
                activation=self.model_config.get("fcnet_activation", "tanh"),
                vf_share_layers=bool(self.model_config.get("vf_share_layers", False)),
                generator=torch.Generator().manual_seed(int(seed)),
            )
        self.device = torch.device(device)
        self.net = net.to(self.device)
        self.params = dict(self.net.named_parameters())

    # The default module is actor-critic shaped; value-free modules (DQN)
    # set this False so runners skip bootstrap-value computation.
    has_value_head = True

    def exploration_inputs(self, timestep: int) -> Mapping:
        """Extra host-computed arrays merged into the exploration forward's
        batch (epsilon schedules etc.)."""
        return {}

    # -- forward passes over explicit parameters ----------------------------

    def apply(self, params, obs):
        if params is self.params:
            # The module's own tensors: the same forward without swapping
            # parameters in and out (functional_call's host cost, paid once
            # a minibatch step).
            return self.net(obs)
        return torch.func.functional_call(self.net, params, (obs,))

    def forward_train(self, params, batch: Mapping) -> dict:
        pi_out, vf = self.apply(params, batch[SampleBatch.OBS])
        return {SampleBatch.ACTION_DIST_INPUTS: pi_out, SampleBatch.VF_PREDS: vf}

    def forward_exploration(self, params, batch: Mapping,
                            generator: Optional[torch.Generator] = None) -> dict:
        pi_out, vf = self.apply(params, batch[SampleBatch.OBS])
        dist = self.dist_cls(pi_out)
        actions = dist.sample(generator)
        return {
            SampleBatch.ACTIONS: actions,
            SampleBatch.ACTION_LOGP: dist.logp(actions),
            SampleBatch.ACTION_DIST_INPUTS: pi_out,
            SampleBatch.VF_PREDS: vf,
        }

    def forward_inference(self, params, batch: Mapping) -> dict:
        pi_out, _ = self.apply(params, batch[SampleBatch.OBS])
        return {SampleBatch.ACTIONS: self.dist_cls(pi_out).deterministic_sample()}

    # -- numpy rollout fast path ------------------------------------------

    def np_exploration_fn(self) -> Optional[Callable]:
        """A pure-numpy forward_exploration for CPU rollout hosts, or None.

        A torch call per env step costs dispatch overhead many times the
        default MLP's math on a [B, obs] stack; the numpy forward is the
        JAX package's, line for line, so the same weights and seeds give
        the same rollouts. Only the stock PiVfNet + Categorical/DiagGaussian
        combination qualifies; custom nets and overridden
        forward_exploration keep the torch path. Weights are re-extracted
        to numpy when the parameters change.

        Returns fn(obs, np_rng) -> fwd dict (same keys/semantics as
        forward_exploration)."""
        from ray_tpu_torch.rllib.core.distributions import Categorical, DiagGaussian

        if type(self).forward_exploration is not RLModule.forward_exploration:
            return None
        if not isinstance(self.net, PiVfNet):
            return None
        if self.dist_cls not in (Categorical, DiagGaussian):
            return None
        return self._np_explore

    def _np_weights(self):
        version = tuple(p._version for p in self.params.values())
        cached = getattr(self, "_np_weight_cache", None)
        if cached is not None and cached[0] == version:
            return cached[1]
        net: PiVfNet = self.net

        def layer(name):
            # Contiguous [in, out], the layout of the flax kernel, so the
            # products are the same BLAS calls as the JAX package's.
            w = self.params[f"{name}.weight"].detach().cpu().numpy()
            b = self.params[f"{name}.bias"].detach().cpu().numpy()
            return np.ascontiguousarray(w.T), b.copy()

        def chain(prefix):
            return [layer(f"{prefix}_{i}") for i in range(len(net.hiddens))]

        weights = {
            "pi": chain("pi"),
            "vf": None if net.vf_share_layers else chain("vf"),
            "pi_head": layer("pi_head"),
            "vf_head": layer("vf_head"),
            "act": {
                "tanh": np.tanh,
                "relu": lambda x: np.maximum(x, 0.0),
                "swish": lambda x: x / (1.0 + np.exp(-x)),
            }[net.activation],
        }
        self._np_weight_cache = (version, weights)
        return weights

    def _np_explore(self, obs: "np.ndarray", rng: "np.random.Generator") -> dict:
        from ray_tpu_torch.rllib.core.distributions import Categorical

        w = self._np_weights()
        act = w["act"]
        x = obs.reshape(obs.shape[0], -1)
        z = x
        for kernel, bias in w["pi"]:
            z = act(z @ kernel + bias)
        pi_out = z @ w["pi_head"][0] + w["pi_head"][1]
        if w["vf"] is None:
            zv = z
        else:
            zv = x
            for kernel, bias in w["vf"]:
                zv = act(zv @ kernel + bias)
        vf = (zv @ w["vf_head"][0] + w["vf_head"][1])[:, 0]
        if self.dist_cls is Categorical:
            # Same normalization as distributions.Categorical so ACTION_LOGP
            # matches what the learner recomputes from ACTION_DIST_INPUTS.
            logits = pi_out - _np_logsumexp(pi_out)
            gumbel = -np.log(
                -np.log(rng.random(pi_out.shape, dtype=np.float64) + 1e-20)
            )
            actions = np.argmax(logits + gumbel, axis=-1)
            logp = np.take_along_axis(logits, actions[:, None], axis=-1)[:, 0]
        else:
            mean, log_std = np.split(pi_out, 2, axis=-1)
            std = np.exp(np.clip(log_std, -20.0, 2.0))
            actions = mean + std * rng.standard_normal(mean.shape).astype(
                mean.dtype
            )
            z_ = (actions - mean) / std
            logp = np.sum(
                -0.5 * z_**2 - np.log(std) - 0.5 * np.log(2.0 * np.pi), axis=-1
            )
        return {
            SampleBatch.ACTIONS: actions,
            SampleBatch.ACTION_LOGP: logp.astype(np.float32),
            SampleBatch.ACTION_DIST_INPUTS: pi_out.astype(np.float32),
            SampleBatch.VF_PREDS: vf.astype(np.float32),
        }

    def np_value_fn(self) -> Optional[Callable]:
        """Pure-numpy V(s) companion to np_exploration_fn (bootstrap
        values at truncations/fragment cuts)."""
        if self.np_exploration_fn() is None:
            return None

        def value(obs: "np.ndarray") -> "np.ndarray":
            w = self._np_weights()
            act = w["act"]
            x = obs.reshape(obs.shape[0], -1)
            z = x
            chain = w["pi"] if w["vf"] is None else w["vf"]
            for kernel, bias in chain:
                z = act(z @ kernel + bias)
            return (z @ w["vf_head"][0] + w["vf_head"][1])[:, 0].astype(
                np.float32
            )

        return value

    # -- state ------------------------------------------------------------

    def get_state(self) -> dict:
        """Host copies of the parameters (name -> CPU tensor)."""
        return {k: v.detach().to("cpu", copy=True) for k, v in self.params.items()}

    def set_state(self, params: Mapping) -> None:
        """Copy `params` (name -> tensor or array, on any device) into the
        module's own tensors on its device."""
        with torch.no_grad():
            for k, v in params.items():
                src = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
                self.params[k].copy_(src)


@dataclasses.dataclass
class RLModuleSpec:
    """Serializable recipe for building an RLModule on a remote worker
    (reference: SingleAgentRLModuleSpec, rl_module.py)."""

    module_class: type = RLModule
    observation_space: Optional[Space] = None
    action_space: Optional[Space] = None
    model_config: Optional[dict] = None
    net_builder: Optional[Callable[[], nn.Module]] = None
    seed: int = 0

    def build(self, device: Any = "cpu") -> RLModule:
        net = self.net_builder() if self.net_builder else None
        return self.module_class(
            self.observation_space,
            self.action_space,
            model_config=self.model_config,
            net=net,
            seed=self.seed,
            device=device,
        )


class MultiAgentRLModule:
    """{module_id: RLModule} container (reference: marl_module.py)."""

    def __init__(self, modules: Mapping[str, RLModule]):
        self._modules = dict(modules)

    def __getitem__(self, module_id: str) -> RLModule:
        return self._modules[module_id]

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def get_state(self) -> dict:
        return {mid: m.get_state() for mid, m in self._modules.items()}

    def set_state(self, state: Mapping) -> None:
        for mid, s in state.items():
            self._modules[mid].set_state(s)
