"""ResNet family (PyTorch).

The port of the reference package's flax ResNet, whose ResNet-50 training
step is its headline Train benchmark. It takes NHWC images, as the
reference does, and computes on NCHW-indexed tensors held in
``torch.channels_last`` memory, so the NHWC input is a view and cuDNN runs
its NHWC convolutions without copying activations.

Numerics follow flax:

* every parameter is f32 and cast to the compute dtype at each use;
  convolutions have no bias; the head is an f32 Dense over the mean of the
  features;
* ``padding="SAME"`` pads each side (t // 2, t - t // 2) with
  t = max((ceil(n / s) - 1) * s + k - n, 0): asymmetric for the 7x7/2 stem
  at 224 (2, 3) and for a 3x3/2 conv or the 3x3/2 max-pool on an even size
  (0, 1). torch's symmetric padding gives the same output size with shifted
  windows, so the pads are explicit;
* GroupNorm: 32 groups, epsilon 1e-6; BatchNorm: epsilon 1e-5 and flax's
  decay 0.9 on the running statistics, whose variance is the biased batch
  variance. Statistics are f32, the variance E[x^2] - E[x]^2 clipped at 0
  (flax's fast variance), and the output is in the compute dtype.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._private.device import resolve_device

GN_GROUPS, GN_EPS = 32, 1e-6  # flax nn.GroupNorm's defaults (torch's eps: 1e-5)
BN_EPS, BN_DECAY = 1e-5, 0.9  # the reference's BatchNorm; torch's momentum = 1 - decay
CL = torch.channels_last


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax / XLA ``padding="SAME"`` for one spatial dim of size n."""
    t = max((-(-n // s) - 1) * s + k - n, 0)
    return t // 2, t - t // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """Pad NCHW `x` for a SAME window; returns (x, conv padding): symmetric
    pads go to the convolution, asymmetric ones through F.pad."""
    (top, bottom), (left, right) = (same_pads(n, k, s) for n in x.shape[2:])
    if top == bottom and left == right:
        return x, (top, left)
    x = F.pad(x, (left, right, top, bottom), value=value)
    return x.contiguous(memory_format=CL), (0, 0)


class Conv(nn.Module):
    """flax nn.Conv(use_bias=False, padding="SAME", dtype=...): an f32
    OIHW kernel in channels_last memory, cast at each use."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(
            torch.empty(cout, cin, kernel, kernel, device=device).to(memory_format=CL))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, padding = _pad_same(x, self.kernel, self.stride)
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride, padding=padding)


def _grouped(x: torch.Tensor, groups: int) -> torch.Tensor:
    """NCHW `x` (channels_last) as [N, H*W, G, C/G]: a view, no copy."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n, h * w, groups, c // groups)


def _ungrouped(y4: torch.Tensor, shape) -> torch.Tensor:
    n, c, h, w = shape
    return y4.reshape(n, h, w, c).permute(0, 3, 1, 2)


class _Normalize(torch.autograd.Function):
    """y = (x - mean) * (rsqrt(var + eps) * scale) + bias over the [N, HW,
    G, C/G] view, in f32, output in x's dtype. With `dims`, mean and var
    are x's statistics over those dims (GroupNorm: (1, 3); BatchNorm in
    training: (0, 1, 3) with G = C) and are returned beside y; with
    `stats` given (BatchNorm's running statistics) they are constants and y
    alone is returned. The
    backward recomputes x-hat from the saved input, so only x (in the
    compute dtype) and the per-group statistics are kept for it."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, dims, eps, stats):
        x4 = _grouped(x, groups).float()
        if stats is None:
            mean = x4.mean(dims, keepdim=True)
            var = torch.clamp((x4 * x4).mean(dims, keepdim=True) - mean * mean, min=0.0)
        else:
            mean, var = stats
        rstd = torch.rsqrt(var + eps)
        y4 = (x4 - mean) * (rstd * scale.view(groups, -1)) + bias.view(groups, -1)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.groups, ctx.dims = groups, dims if stats is None else None
        y = _ungrouped(y4.to(x.dtype), x.shape)
        if stats is not None:
            return y
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, *_):
        x, scale, mean, rstd = ctx.saved_tensors
        g, dims = ctx.groups, ctx.dims
        xhat = (_grouped(x, g).float() - mean) * rstd
        dy4 = _grouped(dy, g).float()
        dscale = (dy4 * xhat).sum((0, 1)).reshape(-1)
        dbias = dy4.sum((0, 1)).reshape(-1)
        dxhat = dy4 * scale.view(g, -1)
        if dims is not None:
            dxhat = (dxhat - dxhat.mean(dims, keepdim=True)
                     - xhat * (dxhat * xhat).mean(dims, keepdim=True))
        dx = _ungrouped((dxhat * rstd).to(x.dtype), x.shape)
        return dx, dscale, dbias, None, None, None, None


class Norm(nn.Module):
    """GroupNorm (``kind="group"``) or BatchNorm (``"batch"``, with running
    ``mean``/``var`` buffers) on NCHW channels_last activations. f32
    ``weight`` (flax's scale) and ``bias``."""

    def __init__(self, channels: int, kind: str = "group", zero_scale: bool = False,
                 device=None):
        super().__init__()
        if kind not in ("group", "batch"):
            raise ValueError(f"norm must be 'group' or 'batch', not {kind!r}")
        self.kind, self.zero_scale = kind, zero_scale
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        if kind == "batch":
            self.register_buffer("mean", torch.zeros(channels, device=device))
            self.register_buffer("var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        if self.kind == "group":
            y, _, _ = _Normalize.apply(x, self.weight, self.bias, GN_GROUPS, (1, 3),
                                       GN_EPS, None)
            return y
        c = x.shape[1]
        if not train:
            stats = (self.mean.view(1, 1, c, 1), self.var.view(1, 1, c, 1))
            return _Normalize.apply(x, self.weight, self.bias, c, None, BN_EPS, stats)
        y, mean, var = _Normalize.apply(x, self.weight, self.bias, c, (0, 1, 3),
                                        BN_EPS, None)
        with torch.no_grad():
            self.mean.mul_(BN_DECAY).add_((1 - BN_DECAY) * mean.view(c))
            self.var.mul_(BN_DECAY).add_((1 - BN_DECAY) * var.view(c))
        return y


class ResNetBlock(nn.Module):
    """Basic block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, norm: str, dtype, device=None):
        super().__init__()
        self.conv_0 = Conv(cin, filters, 3, stride, dtype, device)
        self.norm_0 = Norm(filters, norm, device=device)
        self.conv_1 = Conv(filters, filters, 3, 1, dtype, device)
        self.norm_1 = Norm(filters, norm, zero_scale=True, device=device)
        self.proj = cin != filters  # the presets change width wherever they stride
        if self.proj:
            self.conv_proj = Conv(cin, filters, 1, stride, dtype, device)
            self.norm_proj = Norm(filters, norm, device=device)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        y = F.relu(self.norm_0(self.conv_0(x), train))
        y = self.norm_1(self.conv_1(y), train)
        if self.proj:
            x = self.norm_proj(self.conv_proj(x), train)
        return F.relu(x + y)


class BottleneckBlock(nn.Module):
    """Bottleneck block (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, norm: str, dtype, device=None):
        super().__init__()
        out = filters * 4
        self.conv_0 = Conv(cin, filters, 1, 1, dtype, device)
        self.norm_0 = Norm(filters, norm, device=device)
        self.conv_1 = Conv(filters, filters, 3, stride, dtype, device)
        self.norm_1 = Norm(filters, norm, device=device)
        self.conv_2 = Conv(filters, out, 1, 1, dtype, device)
        self.norm_2 = Norm(out, norm, zero_scale=True, device=device)
        self.proj = cin != out  # the presets change width wherever they stride
        if self.proj:
            self.conv_proj = Conv(cin, out, 1, stride, dtype, device)
            self.norm_proj = Norm(out, norm, device=device)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        y = F.relu(self.norm_0(self.conv_0(x), train))
        y = F.relu(self.norm_1(self.conv_1(y), train))
        y = self.norm_2(self.conv_2(y), train)
        if self.proj:
            x = self.norm_proj(self.conv_proj(x), train)
        return F.relu(x + y)


class ResNet(nn.Module):
    """ResNet over NHWC images [N, H, W, C] → f32 logits [N, classes].

    ``device`` defaults to CUDA and raises without it; tests pass
    ``device="cpu"``. Weights are seeded from a torch.Generator: flax's
    lecun_normal (truncated at two standard deviations) for the conv and
    head kernels, zero biases, unit norm scales except the last norm of
    each block, whose scale starts at zero as in the reference. Parity
    tests load converted reference weights
    (``models.convert.resnet_params_from_flax``)."""

    def __init__(self, stage_sizes: Sequence[int], block_cls, num_classes: int = 1000,
                 num_filters: int = 64, dtype=torch.bfloat16, norm: str = "group",
                 small_inputs: bool = False, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.dtype, self.small_inputs = dtype, small_inputs
        if small_inputs:
            self.conv_init = Conv(3, num_filters, 3, 1, dtype, device)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2, dtype, device)
        self.norm_init = Norm(num_filters, norm, device=device)
        blocks, cin = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(cin, num_filters * 2**i, stride, norm, dtype, device))
                cin = num_filters * 2**i * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes, device=device)
        self.reset_parameters(seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        gen = torch.Generator().manual_seed(seed)
        for module in self.modules():
            if isinstance(module, (Conv, nn.Linear)):
                w = module.weight
                fan_in = w[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                draw = torch.empty(w.shape)
                nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std, generator=gen)
                w.copy_(draw)
                if isinstance(module, nn.Linear):
                    module.bias.zero_()
            elif isinstance(module, Norm):
                module.weight.fill_(0.0 if module.zero_scale else 1.0)
                module.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        # NHWC → NCHW indices over the same channels_last memory.
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.norm_init(self.conv_init(x), train))
        if not self.small_inputs:
            x, padding = _pad_same(x, 3, 2, value=float("-inf"))
            x = F.max_pool2d(x, 3, 2, padding=padding)
        for block in self.blocks:
            x = block(x, train)
        # The features' mean is taken in f32 and rounded to the compute
        # dtype (jnp.mean on bf16); the head is f32.
        x = x.mean((2, 3), dtype=torch.float32).to(self.dtype)
        return F.linear(x.float(), self.head.weight, self.head.bias)


ResNet18 = functools.partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=ResNetBlock)
ResNet34 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=ResNetBlock)
ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock)
ResNet101 = functools.partial(ResNet, stage_sizes=[3, 4, 23, 3], block_cls=BottleneckBlock)
ResNet152 = functools.partial(ResNet, stage_sizes=[3, 8, 36, 3], block_cls=BottleneckBlock)
