"""The kernel-vs-plain check of chip_smoke.py, on synthetic outputs.

chip_smoke.py holds every CUDA kernel against its plain version on the
card; here, on the CPU, its check is shown to pass an output that differs
from the plain one by rounding alone and to refuse outputs that are wrong
in part: zeroed, with a few rows zeroed, or scaled.
"""

import numpy as np
import pytest
import torch

import chip_smoke


def _plain(dtype):
    rng = np.random.RandomState(0)
    # Attention-sized values: most near 0.1, a few rows up to ~4.
    w = rng.randn(4, 256, 64).astype(np.float32) * 0.1
    w[:, :4] *= 40.0
    return torch.from_numpy(w).to(dtype)


def _rounded(w):
    """The plain values perturbed well below one rounding step, then
    rounded to the output's dtype: what a correct kernel gives."""
    noise = torch.from_numpy(np.random.RandomState(1).randn(*w.shape).astype(np.float32))
    step = torch.finfo(w.dtype).eps
    return (w.float() * (1 + 0.25 * step * noise)).to(w.dtype)


def _zero_rows(w):
    out = w.clone()
    out[:, 100:104] = 0
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_check_close_passes_rounding(dtype):
    rows = []
    w = _plain(dtype)
    chip_smoke.check_close(rows, "K0", {"o": _rounded(w)}, {"o": w}, "x", case="t")
    out = rows[-1]["outputs"]["o"]
    assert out["rel_l2"] <= chip_smoke.LIMITS[dtype]["rel_l2"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("wrong", ["zeroed", "rows_zeroed", "scaled", "second_output"])
def test_check_close_refuses_wrong_output(dtype, wrong):
    w = _plain(dtype)
    got = {
        "zeroed": torch.zeros_like(w),
        "rows_zeroed": _zero_rows(w),
        "scaled": (w.float() * (1 + 64 * torch.finfo(dtype).eps)).to(dtype),
        "second_output": w,
    }[wrong]
    # Each output is held on its own: a right first output and a large
    # second one (lse-sized) do not cover a wrong second output.
    lse = torch.full((4, 256), 7.0)
    bad_lse = lse + (1.0 if wrong == "second_output" else 0.0)
    with pytest.raises(SystemExit, match="chip_smoke FAILED"):
        chip_smoke.check_close([], "K0", {"o": got, "lse": bad_lse},
                               {"o": w, "lse": lse}, "x", case="t")


def _resnet_step_results():
    from ray_tpu_torch.models import ResNet18

    model = ResNet18(num_classes=10, num_filters=32, dtype=torch.float32,
                     small_inputs=True, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(0)
    images = torch.randn((2, 8, 8, 3), generator=gen)
    labels = torch.tensor([1, 4])
    return chip_smoke._sgd_step_results(model, images, labels)


@pytest.mark.parametrize("wrong", [None, "loss", "grad", "param"])
def test_resnet_step_comparison_refuses_a_wrong_leaf(wrong):
    """The ResNet phase's card-against-CPU check passes the same step taken
    twice and refuses a loss, one gradient or one parameter off by 1e-3."""
    got = _resnet_step_results()
    want = _resnet_step_results()
    loss, grads, params = got
    if wrong == "loss":
        loss *= 1 + 1e-3
    elif wrong == "grad":
        grads["head.bias"] = grads["head.bias"] * (1 + 1e-3)
    elif wrong == "param":
        params["blocks.3.conv_1.weight"] = params["blocks.3.conv_1.weight"] * (1 + 1e-3)
    res, failures = chip_smoke._compare_steps((loss, grads, params), want,
                                              chip_smoke.RESNET_PARITY_LIMITS)
    assert res["leaves"] == len(grads)
    if wrong is None:
        assert failures == [] and res["loss_rel"] == 0.0
    else:
        assert len(failures) == 1 and failures[0].startswith(wrong if wrong != "grad" else "gradient")


def test_layout_probe_counts_norm_inputs_off_channels_last():
    """The probe behind the ResNet phase's "norm_layout": a channels_last
    run reads 0 of each; inputs in plain NCHW memory are counted."""
    from ray_tpu_torch.models import ResNet18

    model = ResNet18(num_classes=10, num_filters=32, dtype=torch.float32,
                     small_inputs=True, device="cpu", seed=0)
    images = torch.randn(2, 8, 8, 3)
    labels = torch.tensor([1, 4])
    seen = chip_smoke._layout_probe(model, images, labels)
    assert seen["inputs"] == seen["grads"] == 20  # the stem, 2 a block, 3 projections
    assert seen["inputs_not_cl"] == seen["grads_not_cl"] == 0
    model.norm_init.register_forward_pre_hook(lambda m, a: (a[0].contiguous(),) + a[1:])
    seen = chip_smoke._layout_probe(model, images, labels)
    assert seen["inputs_not_cl"] == 1


def test_routing_replay_counts_and_bounds_the_choices_it_overrides():
    """The MoE f32 parity's routing replay: a second run of the same model
    replays the first's expert choices with nothing to override; a run
    whose router is negated has its own choices overridden (counted, with
    a probability margin far past the near-tie bound)."""
    from ray_tpu_torch.models import GPT, GPTConfig

    cfg = GPTConfig(vocab_size=128, num_layers=2, num_heads=4, embed_dim=64,
                    max_seq_len=64, dtype=torch.float32, attention_impl="reference",
                    num_experts=4)
    model = GPT(cfg, device="cpu", seed=0)
    tokens = torch.randint(0, 128, (2, 16), generator=torch.Generator().manual_seed(0))
    with torch.no_grad(), chip_smoke._RoutingReplay() as replay:
        want = model(tokens)
        replay.replay()
        again = model(tokens)
        assert replay.summary()["tokens_whose_own_choice_differed"] == 0
        assert replay.max_margin == 0.0 and torch.equal(again, want)
    with torch.no_grad():
        negated = GPT(cfg, device="cpu", seed=0)
        negated.h[1].moe_mlp.router.neg_()
        with chip_smoke._RoutingReplay() as replay:
            model(tokens)
            replay.replay()
            negated(tokens)
        assert replay.at == len(replay.recorded) == 1
        assert replay.flips > 0 and replay.max_margin > chip_smoke.ROUTING_TIE
    from ray_tpu_torch.models import moe

    assert moe._top_k is replay.inner  # restored on exit
