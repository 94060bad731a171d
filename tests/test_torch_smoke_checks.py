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
