"""ray_tpu_torch.models.resnet against the flax ResNet on converted weights.

The flax variables are made from a seed, passed across as numpy and
converted with `resnet_params_from_flax`; both models then see the same
NHWC images. Every variable is drawn from a seed, norm scales away from
their init (the last norm of each block starts at zero, which would leave
that block's convolutions without a gradient), so each check reaches every
layer. Each numerical trap
between the frameworks is held here: flax's asymmetric SAME padding of the
stride-2 stem, max-pool and 3x3 convs (even and odd sizes), GroupNorm's
epsilon, BatchNorm's decay and biased running variance, bf16 compute on f32
parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.linen import meta

from ray_tpu.models import resnet as ref
from ray_tpu_torch.models import ResNet18, ResNet50, resnet_params_from_flax
from ray_tpu_torch.models.resnet import GN_EPS, same_pads

torch.set_num_threads(1)

# ResNet-18 at 32 base filters: every width divides into GroupNorm's 32
# groups, and a forward at 16x16 takes milliseconds.
SMALL = dict(num_classes=10, num_filters=32)


def _variables(model, hw, seed=0):
    """Flax variables as numpy, by shape (traced, not initialised: flax's
    init compiles for seconds), drawn from a seed: kernels at lecun scale,
    biases and running means near 0, norm scales and running variances in
    U(0.5, 1.5)."""
    x = jnp.zeros((1, hw, hw, 3), jnp.float32)
    shapes = meta.unbox(jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), x, train=False)))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "kernel":
            return (rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _images(b, hw, seed=0):
    return np.random.RandomState(seed).randn(b, hw, hw, 3).astype(np.float32)


def _pair(hw, dtype="float32", norm="group", small_inputs=True):
    jm = ref.ResNet18(**SMALL, dtype=getattr(jnp, dtype), norm=norm, small_inputs=small_inputs)
    variables = _variables(jm, hw)
    model = ResNet18(**SMALL, dtype=getattr(torch, dtype), norm=norm,
                     small_inputs=small_inputs, device="cpu")
    model.load_state_dict(resnet_params_from_flax(variables))
    return jm, variables, model


def test_small_inputs_forward_matches_flax_f32():
    jm, variables, model = _pair(16)
    x = _images(2, 16)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=True))
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == (2, 10)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("hw", [64, 65])
def test_stem_same_padding_matches_flax(hw):
    """The 7x7/2 stem and the 3x3/2 max-pool pad (2, 3) and (0, 1) at 64,
    (3, 3) and (1, 1) at 65; the stage convs then see even and odd sizes."""
    assert same_pads(224, 7, 2) == (2, 3) and same_pads(112, 3, 2) == (0, 1)
    assert same_pads(65, 7, 2) == (3, 3) and same_pads(33, 3, 2) == (1, 1)
    jm, variables, model = _pair(hw, small_inputs=False)
    x = _images(2, hw, seed=1)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=True))
    got = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_batchnorm_train_updates_stats_and_eval_reads_them():
    """train=True: the output and the updated batch_stats (decay 0.9, the
    biased batch variance); train=False: the output from the running
    statistics, which then stay as they were."""
    jm, variables, model = _pair(16, norm="batch")
    x = _images(4, 16, seed=2)
    want, updated = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    got = model(torch.from_numpy(x), train=True).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    new_stats = resnet_params_from_flax(
        {"params": variables["params"], "batch_stats": updated["batch_stats"]})
    sd = model.state_dict()
    stat_keys = [k for k in new_stats if k.endswith((".mean", ".var"))]
    assert len(stat_keys) == 2 * (1 + 8 * 2 + 3)  # stem, 2 per block, 3 projections
    for k in stat_keys:
        np.testing.assert_allclose(sd[k].numpy(), new_stats[k].numpy(), atol=1e-6, err_msg=k)
    # Both now hold the same running statistics: evaluate with them.
    variables = {"params": variables["params"], "batch_stats": updated["batch_stats"]}
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = model(torch.from_numpy(x), train=False).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


def test_forward_bf16_within_tolerance():
    """bf16 compute on f32 parameters: both sides round each convolution's
    output and each norm's output to bf16, in different orders. Stated
    bound: logits within 3e-2 of the flax bf16 model's (measured 1.3e-2 on
    logits of magnitude ~1.8), and the port's bf16 logits within 5e-2 of
    the f32 model's."""
    jm, variables, model = _pair(16, dtype="bfloat16")
    x = _images(2, 16)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=True))
    got = model(torch.from_numpy(x)).detach()
    assert got.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(got.numpy(), want, atol=3e-2)
    f32 = ResNet18(**SMALL, dtype=torch.float32, small_inputs=True, device="cpu")
    f32.load_state_dict(model.state_dict())
    np.testing.assert_allclose(got.numpy(), f32(torch.from_numpy(x)).detach().numpy(),
                               atol=5e-2)


def test_resnet50_parameter_count_and_names_round_trip():
    tree = _variables(ref.ResNet50(num_classes=1000), 224)
    flax_count = sum(a.size for a in jax.tree_util.tree_leaves(tree["params"]))
    assert flax_count == 25_557_032
    model = ResNet50(device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 25_557_032
    assert len(model.blocks) == 16
    # The seeded init zeroes the last norm of each block, as flax's does.
    assert all(torch.all(b.norm_2.weight == 0) for b in model.blocks)
    assert torch.all(model.blocks[0].norm_1.weight == 1)
    sd = resnet_params_from_flax(tree)
    model.load_state_dict(sd)  # strict: every name maps, none is left over
    assert set(sd) == set(model.state_dict())
    p = tree["params"]
    np.testing.assert_array_equal(
        model.blocks[15].conv_1.weight.detach().numpy(),
        p["BottleneckBlock_15"]["Conv_1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        model.blocks[0].norm_proj.weight.detach().numpy(),
        p["BottleneckBlock_0"]["norm_proj"]["scale"])
    np.testing.assert_array_equal(model.head.weight.detach().numpy(),
                                  p["head"]["kernel"].T)
    assert model.conv_init.weight.is_contiguous(memory_format=torch.channels_last)
    assert GN_EPS == 1e-6


def test_sgd_momentum_step_matches_optax():
    """One step of bench.py's ResNet training step in f32 (softmax cross
    entropy on integer labels, optax.sgd(0.1, momentum=0.9), which is
    torch.optim.SGD(lr=0.1, momentum=0.9): the first step's momentum buffer
    is the gradient): the loss within 1e-5, every gradient and every
    parameter after the update within 1e-4 relative L2."""
    jm, variables, model = _pair(16)
    x = _images(4, 16, seed=3)
    labels = np.array([1, 7, 3, 0])
    params = variables["params"]

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(x), train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), jnp.asarray(labels)).mean()

    loss_ref, grads_ref = jax.jit(jax.value_and_grad(loss_fn))(params)
    tx = optax.sgd(0.1, momentum=0.9)
    updates, _ = tx.update(grads_ref, tx.init(params), params)
    stepped = optax.apply_updates(params, updates)
    to_port = lambda tree: resnet_params_from_flax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, {"params": tree}))

    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    loss = torch.nn.functional.cross_entropy(
        model(torch.from_numpy(x)).float(), torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    want_grads = to_port(grads_ref)
    rel = lambda a, b: float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))  # noqa: E731
    for name, p in model.named_parameters():
        assert rel(p.grad.numpy(), want_grads[name].numpy()) < 1e-4, name
    opt.step()
    want_params = to_port(stepped)
    for name, p in model.named_parameters():
        assert rel(p.detach().numpy(), want_params[name].numpy()) < 1e-4, name


def test_default_device_raises_without_cuda():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ResNet18(**SMALL)
