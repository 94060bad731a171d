"""Learner — SGD over an RLModule on the learner's device.

Reference: rllib/core/learner/learner.py (:170 build, :482 update, :604
compute_gradients, :1086 apply_gradients) and torch_learner.py:51 (framework
learner). The JAX package runs the whole epochs x minibatches loop as one
jitted scan; here the same loop runs eagerly on the learner's device (the
card by default): the train batch is copied there once per update, each
minibatch is gathered there, and the per-minibatch metrics stay there until
one copy to the host at the end of the update. Subclasses implement
`compute_loss(params, batch, rng, extra)` returning (scalar_loss,
metrics_dict); everything else is generic. A loss that consumes random
draws (SAC's squashed samples, TD3's smoothing noise, CQL's action sets)
gets them as `rng`: `sample_noise(batch)` draws them first from the
learner's device generator, so the loss is a pure function of its noise.

The optimizer is optax's `chain(clip_by_global_norm(clip), adam(lr))`
written out in torch in optax's order of operations (`ClippedAdam`):
`torch.nn.utils.clip_grad_norm_` divides by `norm + 1e-6` and
`torch.optim.Adam` folds the bias corrections differently, so neither is
used.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec
from ray_tpu_torch.rllib.policy.sample_batch import SampleBatch

DEVICE_COLUMNS_EXCLUDED = (SampleBatch.INFOS,)


def to_device_batch(batch: Mapping, device) -> dict:
    """The numeric columns of `batch` as tensors on `device`, in one copy
    each. float64 columns become float32, as `jnp.asarray` makes them."""
    out = {}
    for k, v in batch.items():
        if k in DEVICE_COLUMNS_EXCLUDED or not isinstance(v, np.ndarray) or v.dtype == object:
            continue
        if v.dtype == np.float64:
            v = v.astype(np.float32)
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return out


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every element's square."""
    squares = torch._foreach_mul(tensors, tensors)
    return torch.sqrt(torch.stack([s.sum() for s in squares]).sum())


class ClippedAdam:
    """optax.chain(clip_by_global_norm(clip), adam(lr, 0.9, 0.999, 1e-8)),
    applied in place to a name -> tensor dict. The state is
    {"count": int, "mu": {name: tensor}, "nu": {name: tensor}} on the
    parameters' device; the count stays on the host, so a step never waits
    for the device."""

    def __init__(self, lr: float, clip: Optional[float] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr = float(lr)
        self.clip = float(clip) if clip else None
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Mapping) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()},
        }

    @torch.no_grad()
    def step(self, params: Mapping, grads: list, state: dict) -> torch.Tensor:
        """One update of `params` (in place) and `state`; returns the global
        norm of `grads` before the clip."""
        keys = list(params)
        norm = global_norm(grads)
        if self.clip is not None:
            # optax: select(norm < clip, g, (g / norm) * clip).
            grads = [torch.where(norm < self.clip, g, (g / norm) * self.clip) for g in grads]
        mu = [state["mu"][k] for k in keys]
        nu = [state["nu"][k] for k in keys]
        b1, b2 = self.b1, self.b2
        # (1 - b) * g**order + b * moment, as optax's update_moment.
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
        state["count"] += 1
        count = np.float32(state["count"])
        # 1 - decay**count in float32, as optax's bias_correction.
        bc1 = float(np.float32(1.0) - np.float32(b1) ** count)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** count)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        torch._foreach_mul_(updates, -self.lr)
        torch._foreach_add_([params[k] for k in keys], updates)
        return norm


class Learner:
    """Owns module params + Adam state on its device; runs the update."""

    # Subclasses whose loss depends on intra-batch row order (V-trace
    # fragments) set this False; minibatches then iterate in input order.
    shuffle_minibatches = True

    def __init__(
        self,
        module_spec: RLModuleSpec,
        config: Optional[Any] = None,
        mesh: Optional[Any] = None,
        device: Optional[Any] = None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "Learner(mesh=...): the sharded learner waits for the port's "
                "parallel layer (ROADMAP.md §B7)"
            )
        self.config = config
        self.module_spec = module_spec
        self.module = None
        self._device_request = (
            device if device is not None else getattr(config, "learner_device", None)
        )
        self.device: Optional[torch.device] = None
        self._opt_state = None
        seed = getattr(config, "seed", 0) or 0
        # Epoch row orders are drawn on the host from this generator
        # (`_epoch_order`); the loss's own generator lives on the device.
        self._generator = torch.Generator().manual_seed(int(seed))
        self._seed = int(seed)
        self._rng: Optional[torch.Generator] = None
        # What the JAX package traces into a cached update program: frozen
        # per update shape at its first use (`program_constants`).
        self._programs: dict = {}
        self._constants: Optional[dict] = None
        self._built = False

    # -- construction -----------------------------------------------------

    def build(self) -> None:
        if self._built:
            return
        self.device = resolve_device(self._device_request)
        self.module = self.module_spec.build(device=self.device)
        self.optimizer = self.configure_optimizer()
        self._opt_state = self.optimizer.init(self.module.params)
        self._rng = torch.Generator(device=self.device).manual_seed(self._seed)
        # Read-only state fed into the loss (target networks etc.) —
        # mutated in after_update.
        self.extra_train_state = self.initial_extra_state()
        self._built = True

    def initial_extra_state(self) -> Any:
        return {}

    def configure_optimizer(self) -> ClippedAdam:
        lr = getattr(self.config, "lr", 5e-4) if self.config else 5e-4
        clip = getattr(self.config, "grad_clip", None) if self.config else None
        return ClippedAdam(lr, clip)

    def program_constants(self) -> dict:
        """Values the JAX package's learner reads at trace time and bakes
        into the update program it caches per update shape; the port freezes
        them the same way (see PPOLearner and ROADMAP.md §D18)."""
        return {}

    # -- algorithm hook ----------------------------------------------------

    def compute_loss(
        self, params, batch: Mapping, rng, extra=None
    ) -> Tuple[torch.Tensor, dict]:
        raise NotImplementedError

    def sample_noise(self, batch: Mapping) -> Any:
        """The random draws `compute_loss` consumes on `batch` (a minibatch
        on the device), made from the learner's device generator before the
        loss runs; the generator itself for losses that draw nothing."""
        return self._rng

    # -- update path -------------------------------------------------------

    def update(self, batch: SampleBatch) -> dict:
        """Minibatch SGD over `batch`: num_epochs x (count // minibatch_size)
        steps; returns the metrics averaged over every step (reference
        learner.py:482 update semantics, and the JAX package's scanned
        update, `_make_scanned_update_fn`)."""
        assert self._built, "call build() first"
        cfg = self.config
        minibatch_size = getattr(cfg, "minibatch_size", None) or batch.count
        num_epochs = getattr(cfg, "num_epochs", 1) or 1
        out = self._update_epochs(batch, int(minibatch_size), int(num_epochs))
        self.after_update(batch)
        return out

    def _epoch_order(self, n: int, n_rows: int) -> torch.Tensor:
        """One epoch's rows: a permutation of ALL n rows, of which the first
        n_rows are used, so DIFFERENT remainder rows drop each epoch."""
        return torch.randperm(n, generator=self._generator)[:n_rows]

    def _update_epochs(self, batch: SampleBatch, minibatch_size: int,
                       num_epochs: int) -> dict:
        device_batch = to_device_batch(batch, self.device)
        n = batch.count
        minibatch_size = min(minibatch_size, n)
        num_minibatches = max(1, n // minibatch_size)
        n_rows = num_minibatches * minibatch_size
        if n_rows != n and not self.shuffle_minibatches:
            # Order-dependent losses (V-trace fragments) can't resample the
            # remainder; drop the partial tail.
            device_batch = {k: v[:n_rows] for k, v in device_batch.items()}
            n = n_rows
        key = (n, num_minibatches, minibatch_size, num_epochs)
        self._constants = self._programs.setdefault(key, self.program_constants())
        steps = []
        try:
            for _ in range(num_epochs):
                order = (self._epoch_order(n, n_rows).to(self.device)
                         if self.shuffle_minibatches else None)
                for i in range(num_minibatches):
                    lo, hi = i * minibatch_size, (i + 1) * minibatch_size
                    if order is None:
                        mb = {k: v[lo:hi] for k, v in device_batch.items()}
                    else:
                        take = order[lo:hi]
                        mb = {k: v.index_select(0, take) for k, v in device_batch.items()}
                    steps.append(self._sgd_step(mb))
        finally:
            self._constants = None
        names = list(steps[0])
        # One host copy for the whole update.
        means = torch.stack([torch.stack([s[k].float() for k in names]) for s in steps])
        return dict(zip(names, means.mean(dim=0).tolist()))

    def _loss_and_grads(self, batch: Mapping):
        params = self.module.params
        loss, metrics = self.compute_loss(params, batch, self.sample_noise(batch),
                                          self.extra_train_state)
        tensors = list(params.values())
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(tensors, grads)]
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in dict(metrics).items()}
        metrics["total_loss"] = loss.detach()
        return grads, metrics

    def _sgd_step(self, batch: Mapping) -> dict:
        grads, metrics = self._loss_and_grads(batch)
        metrics["grad_norm"] = self.optimizer.step(self.module.params, grads, self._opt_state)
        return metrics

    def after_update(self, batch: SampleBatch) -> None:
        """Post-update hook (target-network sync etc.)."""

    # -- gradient-level API (reference learner.py:604,:1086) ---------------

    def compute_gradients(self, batch: SampleBatch) -> Tuple[dict, dict]:
        """Gradients of the loss over the whole of `batch` (host copies,
        name -> CPU tensor) and its metrics (floats; per-sample arrays pass
        through as numpy)."""
        assert self._built
        # The JAX package's jitted gradient function traces once per batch shape.
        self._constants = self._programs.setdefault(("gradients", batch.count),
                                                    self.program_constants())
        try:
            grads, metrics = self._loss_and_grads(to_device_batch(batch, self.device))
        finally:
            self._constants = None
        out = {}
        for k, v in metrics.items():
            v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            # Scalars stay floats; per-sample diagnostics (td errors) pass
            # through as arrays for the LearnerGroup to concatenate.
            out[k] = float(v) if np.ndim(v) == 0 else v
        host = {k: g.detach().cpu() for k, g in zip(self.module.params, grads)}
        return host, out

    def apply_gradients(self, grads: Mapping) -> None:
        assert self._built
        params = self.module.params
        device_grads = [torch.as_tensor(grads[k]).to(self.device) for k in params]
        self.optimizer.step(params, device_grads, self._opt_state)

    # -- state -------------------------------------------------------------

    def get_weights(self) -> dict:
        return self.module.get_state()

    def set_weights(self, weights: Any) -> None:
        self.module.set_state(weights)

    def get_state(self) -> dict:
        """Host copies: checkpoints and runners never hold card memory."""

        def host(tree):
            if isinstance(tree, torch.Tensor):
                return tree.detach().to("cpu", copy=True)
            if isinstance(tree, dict):
                return {k: host(v) for k, v in tree.items()}
            return tree

        return {
            "weights": self.module.get_state(),
            "opt_state": host(self._opt_state),
            "extra": host(self.extra_train_state),
        }

    def set_state(self, state: Mapping) -> None:
        self.module.set_state(state["weights"])
        opt = state["opt_state"]
        with torch.no_grad():
            for moment in ("mu", "nu"):
                for k, v in opt[moment].items():
                    self._opt_state[moment][k].copy_(torch.as_tensor(v))
        self._opt_state["count"] = int(opt["count"])
        if "extra" in state:
            # Target networks come back to the learner's device.
            def to_device(tree):
                if isinstance(tree, torch.Tensor):
                    return tree.to(self.device, copy=True)
                if isinstance(tree, dict):
                    return {k: to_device(v) for k, v in tree.items()}
                return tree

            self.extra_train_state = to_device(state["extra"])


class MultiAgentLearner:
    """Independent per-policy optimization (reference: marl_module.py +
    the per-module update loop in learner.py): one sub-learner per policy,
    each with its OWN parameters and optimizer state. An update routes each
    policy's sub-batch of a MultiAgentBatch to its learner; policies absent
    from a batch are untouched."""

    def __init__(self, learner_builders: Mapping[str, Callable]):
        self._learners = {pid: b() for pid, b in learner_builders.items()}

    def build(self) -> None:
        for learner in self._learners.values():
            learner.build()

    def __getitem__(self, policy_id: str) -> Learner:
        return self._learners[policy_id]

    def keys(self):
        return self._learners.keys()

    def update(self, batch) -> dict:
        out: dict = {}
        for pid, sub in batch.items():
            learner = self._learners.get(pid)
            if learner is None or sub.count == 0:
                continue
            for k, v in learner.update(sub).items():
                out[f"{pid}/{k}"] = v
        return out

    def after_update(self, batch) -> None:
        pass

    def get_weights(self) -> dict:
        return {pid: lr.get_weights() for pid, lr in self._learners.items()}

    def set_weights(self, weights: Mapping) -> None:
        for pid, w in weights.items():
            if pid in self._learners:
                self._learners[pid].set_weights(w)

    def get_state(self) -> dict:
        return {pid: lr.get_state() for pid, lr in self._learners.items()}

    def set_state(self, state: Mapping) -> None:
        for pid, s in state.items():
            if pid in self._learners:
                self._learners[pid].set_state(s)
