"""A plain Vision Transformer over a dict of timm/DINOv2-keyed tensors.

The DeiT student and the DINOv2 teacher of the configurations (pre-norm
blocks, LayerNorm eps 1e-6, exact GELU, LayerScale where the teacher has
it, per-sample drop path), returning per-layer patch tokens and the CLS
attention importance: the CLS query's softmax over all keys, the patch
columns kept, averaged over heads. Everything runs in float32. For the
precision control (`fp8=True`) every value that a model computing in a
low-precision dtype holds in that dtype (weights and inputs of each
product, its output, the attention probabilities, LayerNorm and GELU
outputs, the residual stream) is rounded to float8 e4m3 with one scale per
tensor, and so is the gradient that the backward hands back through it (the
program's backward holds it in the same low-precision dtype).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_LN_EPS = 1e-6
_E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale."""
    scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _RoundFp8(torch.autograd.Function):
    """x rounded to float8 e4m3 under a per-tensor scale; the backward
    rounds the gradient the same way."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def low(x: torch.Tensor, fp8: bool) -> torch.Tensor:
    """`x` as the precision control holds it: rounded to float8 e4m3."""
    return _RoundFp8.apply(x) if fp8 else x


def _linear(x, p, name, fp8):
    out = F.linear(low(x, fp8), low(p[name + ".weight"], fp8), low(p[name + ".bias"], fp8))
    return low(out, fp8)


def _ln(x, p, name, fp8=False):
    out = F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], _LN_EPS)
    return low(out, fp8)


def _attention(x, p, name, heads, fp8):
    b, n, d = x.shape
    hd = d // heads
    scale = hd ** -0.5
    qkv = _linear(x, p, name + ".qkv", fp8)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    split = lambda t: t.reshape(b, n, heads, hd).transpose(1, 2)
    qh, kh, vh = split(low(q * scale, fp8)), split(k), split(v)
    attn = low(torch.softmax(qh @ kh.transpose(-1, -2), dim=-1), fp8)
    out = low((attn @ vh).transpose(1, 2).reshape(b, n, d), fp8)
    cls_logits = (k * q[:, :1]).reshape(b, n, heads, hd).sum(-1).transpose(1, 2) * scale
    importance = torch.softmax(cls_logits, dim=-1)[:, :, 1:].mean(dim=1)
    return _linear(out, p, name + ".proj", fp8), importance


def _drop_path(x, u, rate):
    if u is None:
        return x
    keep = 1.0 - rate
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


def block_rates(depth: int, drop_path_rate: float) -> list[float]:
    """Each block's drop-path rate, rising linearly from 0 to the rate."""
    if drop_path_rate <= 0:
        return [0.0] * depth
    return [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]


def draw_drop_path(generator, batch, depth, drop_path_rate, device):
    """Two (B, 1, 1) uniforms per block whose rate is not 0, in block
    order: the calls the student's forward makes on the step's generator."""
    out = []
    for rate in block_rates(depth, drop_path_rate):
        if rate == 0.0:
            out.append((None, None))
        else:
            out.append(tuple(torch.rand((batch, 1, 1), device=device, generator=generator)
                             for _ in range(2)))
    return out


def vit_forward(p, images, *, patch_size, depth, heads, capture, drop_path_rate=0.0,
                draws=None, layer_scale=False, head=True, fp8=False):
    """(logits or None, tokens (P, B, N, D), importance (P, B, N)) of
    (B, H, W, 3) float images; `capture` the blocks whose tokens are kept."""
    b = images.shape[0]
    x = low(F.conv2d(low(images.permute(0, 3, 1, 2), fp8),
                     low(p["patch_embed.proj.weight"], fp8),
                     low(p["patch_embed.proj.bias"], fp8), stride=patch_size), fp8)
    x = x.flatten(2).transpose(1, 2)
    x = low(torch.cat([low(p["cls_token"], fp8).expand(b, 1, -1), x], dim=1)
            + low(p["pos_embed"], fp8), fp8)
    rates = block_rates(depth, drop_path_rate)
    tokens, imps = [], []
    for i in range(depth):
        name = f"blocks.{i}"
        u1, u2 = draws[i] if draws is not None else (None, None)
        y, importance = _attention(_ln(x, p, name + ".norm1", fp8), p, name + ".attn", heads,
                                   fp8)
        if layer_scale:
            y = low(y * low(p[name + ".ls1.gamma"], fp8), fp8)
        x = low(x + _drop_path(y, u1, rates[i]), fp8)
        h = low(F.gelu(_linear(_ln(x, p, name + ".norm2", fp8), p, name + ".mlp.fc1", fp8)), fp8)
        y = _linear(h, p, name + ".mlp.fc2", fp8)
        if layer_scale:
            y = low(y * low(p[name + ".ls2.gamma"], fp8), fp8)
        x = low(x + _drop_path(y, u2, rates[i]), fp8)
        if i in capture:
            tokens.append(x[:, 1:])
            imps.append(importance)
    logits = None
    if head:
        logits = F.linear(_ln(x, p, "norm", fp8)[:, 0], p["head.weight"], p["head.bias"])
    return logits, torch.stack(tokens), torch.stack(imps)
