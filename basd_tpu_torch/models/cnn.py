"""CNN teachers (ResNet, ConvNeXt V1/V2) with the token interface of the
ViT: the port of `basd_tpu/models/cnn.py`.

A CNN teacher gives one token layer, its last feature map as (1, B, h*w, D)
fp32 tokens in row-major (h, w) order, and uniform importance 1/N. Images
are (B, H, W, 3), as everywhere in the port. Parameters are fp32 with
torchvision/timm state-dict keys (`models.convert` carries the JAX
package's weights onto them); every conv and dense layer casts its input
and weights to the config's dtype, as flax's `dtype=` does, and the norms
compute in fp32 and round to that dtype.

Flax's "SAME" padding of a strided conv or pool is asymmetric (lo, hi) with
hi >= lo; torch's `padding=` is symmetric, so every pad is taken from the
flax formula and applied with `F.pad` (max-pool pads with -inf).

Teachers are frozen: BatchNorm always normalizes with its running
statistics.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from basd_tpu_torch.models.vit import _LN_EPS, _layer_norm, _linear, _trunc_normal_
from basd_tpu_torch.ops.activations import gelu

_BN_EPS = 1e-5  # flax BatchNorm default


class CNNOutput(NamedTuple):
    logits: torch.Tensor  # (B, num_classes) fp32, or the pooled features
    tokens: torch.Tensor  # (1, B, N, D) fp32 last-stage tokens
    importance: torch.Tensor  # (1, B, N) fp32, uniform 1/N


def _uniform_importance(b: int, n: int, device) -> torch.Tensor:
    return torch.full((1, b, n), 1.0 / n, dtype=torch.float32, device=device)


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """Flax/XLA "SAME" padding (lo, hi) of one spatial axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0) -> torch.Tensor:
    """Pad NCHW `x` for a k x k window at stride s as flax's "SAME" does."""
    top, bottom = _same_pads(x.shape[-2], k, s)
    left, right = _same_pads(x.shape[-1], k, s)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def _conv(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """NCHW conv in `dtype` with flax's "SAME" padding."""
    k, s = conv.kernel_size[0], conv.stride[0]
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(_pad_same(x.to(dtype), k, s), conv.weight.to(dtype), bias,
                    stride=s, groups=conv.groups)


def _conv_nhwc(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """`_conv` on an NHWC tensor (an NCHW view of it, channels-last)."""
    return _conv(x.permute(0, 3, 1, 2), conv, dtype).permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """Frozen BatchNorm over NCHW channels with torchvision's keys
    (weight, bias, running_mean, running_var): flax's
    (x - mean) * (rsqrt(var + eps) * scale) + bias in fp32, rounded to x's
    dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        col = lambda p: p[None, :, None, None]
        mul = torch.rsqrt(self.running_var + _BN_EPS) * self.weight
        y = (x.float() - col(self.running_mean)) * col(mul) + col(self.bias)
        return y.to(x.dtype)


def _init_cnn(module: nn.Module, seed: int, layer_scale: float) -> None:
    """The JAX package's initializers, drawn from a CPU generator seeded
    with `seed`: fan-out normal for every conv (`he_conv_init`), flax's
    default Dense init (truncated normal, variance 1/fan_in) for the dense
    layers, zero biases, unit norms, BatchNorm statistics (0, 1), GRN at
    0 and the ConvNeXt-V1 layer scale at `layer_scale`."""
    g = torch.Generator().manual_seed(seed)

    def draw(p, fill):
        cpu = torch.empty(p.shape, dtype=p.dtype)
        fill(cpu)
        p.copy_(cpu)

    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, nn.Conv2d):
                kh, kw = mod.kernel_size
                std = math.sqrt(2.0 / (kh * kw * mod.out_channels))
                draw(mod.weight, lambda w: w.normal_(0.0, std, generator=g))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Linear):
                std = math.sqrt(1.0 / mod.in_features)
                draw(mod.weight, lambda w: _trunc_normal_(w, std, g))
                mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, BatchNorm):
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)
            elif isinstance(mod, GRN):
                mod.weight.zero_()
                mod.bias.zero_()
            elif isinstance(mod, ConvNeXtBlock) and mod.gamma is not None:
                mod.gamma.fill_(layer_scale)


def _tokens_and_logits(x_nhwc: torch.Tensor, head: nn.Linear | None) -> CNNOutput:
    b, h, w, d = x_nhwc.shape
    tokens = x_nhwc.reshape(b, h * w, d).float()[None]
    pooled = x_nhwc.mean(dim=(1, 2)).float()
    logits = pooled if head is None else F.linear(pooled, head.weight, head.bias)
    return CNNOutput(logits, tokens, _uniform_importance(b, h * w, x_nhwc.device))


# ---------------------------------------------------------------------------
# ResNet
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: tuple[int, ...] = (2, 2, 2, 2)  # resnet18
    width: int = 64
    num_classes: int = 0
    dtype: torch.dtype = torch.bfloat16


class BasicBlock(nn.Module):
    def __init__(self, in_dim: int, filters: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_dim, filters, 3, stride=stride, bias=False)
        self.bn1 = BatchNorm(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, bias=False)
        self.bn2 = BatchNorm(filters)
        if stride != 1 or in_dim != filters:
            self.downsample = nn.ModuleList([
                nn.Conv2d(in_dim, filters, 1, stride=stride, bias=False),
                BatchNorm(filters),
            ])
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        y = F.relu(self.bn1(_conv(x, self.conv1, dtype)))
        y = self.bn2(_conv(y, self.conv2, dtype))
        residual = x
        if self.downsample is not None:
            conv, bn = self.downsample
            residual = bn(_conv(x, conv, dtype))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """BasicBlock ResNet (the JAX package's `resnet*` presets, not
    torchvision's bottleneck ResNet-50), NCHW inside."""

    def __init__(self, config: ResNetConfig):
        super().__init__()
        cfg = self.config = config
        self.conv1 = nn.Conv2d(3, cfg.width, 7, stride=2, bias=False)
        self.bn1 = BatchNorm(cfg.width)
        in_dim = cfg.width
        for stage, num_blocks in enumerate(cfg.stage_sizes):
            filters = cfg.width * 2**stage
            blocks = []
            for block in range(num_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(BasicBlock(in_dim, filters, stride))
                in_dim = filters
            setattr(self, f"layer{stage + 1}", nn.ModuleList(blocks))
        self.fc = nn.Linear(in_dim, cfg.num_classes) if cfg.num_classes > 0 else None

    def init_weights(self, seed: int) -> None:
        _init_cnn(self, seed, layer_scale=0.0)

    def forward(self, x: torch.Tensor, *, train: bool = False) -> CNNOutput:
        del train  # frozen: BatchNorm uses its running statistics
        dt = self.config.dtype
        x = F.relu(self.bn1(_conv(x.to(dt).permute(0, 3, 1, 2), self.conv1, dt)))
        x = F.max_pool2d(_pad_same(x, 3, 2, value=-math.inf), 3, stride=2)
        for stage in range(len(self.config.stage_sizes)):
            for blk in getattr(self, f"layer{stage + 1}"):
                x = blk(x, dt)
        return _tokens_and_logits(x.permute(0, 2, 3, 1), self.fc)


# ---------------------------------------------------------------------------
# ConvNeXt
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ConvNeXtConfig:
    depths: tuple[int, ...] = (3, 3, 9, 3)  # convnext-tiny
    dims: tuple[int, ...] = (96, 192, 384, 768)
    num_classes: int = 0
    use_grn: bool = False  # ConvNeXt-V2: GRN in the MLP, no layer scale
    dtype: torch.dtype = torch.bfloat16


class GRN(nn.Module):
    """Global Response Normalization (ConvNeXt-V2), timm's
    `mlp.grn.weight`/`bias` stored as (C,): on NHWC y,
    gx = ||y||_2 over the spatial axes per channel, nx = gx / (mean_c gx +
    1e-6), out = weight * (y * nx) + bias + y, all in fp32, rounded to
    y's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        yf = y.float()
        gx = torch.sqrt(torch.sum(yf * yf, dim=(1, 2), keepdim=True))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return (self.weight * (yf * nx) + self.bias + yf).to(y.dtype)


class ConvNeXtMlp(nn.Module):
    def __init__(self, dim: int, use_grn: bool):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.grn = GRN(4 * dim) if use_grn else None
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        y = gelu(_linear(x, self.fc1, dtype))
        if self.grn is not None:
            y = self.grn(y)
        return _linear(y, self.fc2, dtype)


class ConvNeXtBlock(nn.Module):
    """dwconv 7x7 -> LayerNorm -> fc1 -> GELU [-> GRN] -> fc2, plus the
    residual; V1 scales the branch by the layer scale `gamma`, V2 has
    none."""

    def __init__(self, dim: int, use_grn: bool):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 7, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=_LN_EPS)
        self.mlp = ConvNeXtMlp(dim, use_grn)
        self.gamma = None if use_grn else nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        y = _layer_norm(_conv_nhwc(x, self.conv_dw, dtype), self.norm)
        y = self.mlp(y, dtype)
        if self.gamma is not None:
            y = self.gamma.to(dtype) * y
        return x + y


class ConvNeXtStage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int, use_grn: bool, first: bool):
        super().__init__()
        self.downsample = None if first else nn.ModuleList([
            nn.LayerNorm(in_dim, eps=_LN_EPS), nn.Conv2d(in_dim, dim, 2, stride=2)])
        self.blocks = nn.ModuleList(ConvNeXtBlock(dim, use_grn) for _ in range(depth))


class ConvNeXt(nn.Module):
    """ConvNeXt (V1, or V2 with `use_grn`) with timm's keys, NHWC inside."""

    def __init__(self, config: ConvNeXtConfig):
        super().__init__()
        cfg = self.config = config
        self.stem = nn.ModuleList([nn.Conv2d(3, cfg.dims[0], 4, stride=4),
                                   nn.LayerNorm(cfg.dims[0], eps=_LN_EPS)])
        self.stages = nn.ModuleList(
            ConvNeXtStage(cfg.dims[max(s - 1, 0)], dim, depth, cfg.use_grn, s == 0)
            for s, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims))
        )
        self.head = (nn.ModuleDict({"fc": nn.Linear(cfg.dims[-1], cfg.num_classes)})
                     if cfg.num_classes > 0 else None)

    def init_weights(self, seed: int) -> None:
        _init_cnn(self, seed, layer_scale=1e-6)

    def forward(self, x: torch.Tensor, *, train: bool = False) -> CNNOutput:
        del train
        dt = self.config.dtype
        conv, norm = self.stem
        x = _layer_norm(_conv_nhwc(x.to(dt), conv, dt), norm)
        for stage in self.stages:
            if stage.downsample is not None:
                norm, conv = stage.downsample
                x = _conv_nhwc(_layer_norm(x, norm), conv, dt)
            for blk in stage.blocks:
                x = blk(x, dt)
        return _tokens_and_logits(x, None if self.head is None else self.head["fc"])
