"""The DINOv3 ViT forward (the ViT-7B/16's blocks) in plain torch and
float32: the reference that the CPU tests hold the port's `models/vit.py`
(its RoPE path, `ops.rope.rope_qk`, the register tokens and LayerNorm eps)
to.

Over a dict of timm/DINOv2-keyed tensors (the port's state-dict keys, no
`pos_embed`): patch embedding, then [CLS | register_tokens | patches]; per
block x + ls1 * attn(LN x) and x + ls2 * fc2(silu(a) * b), where fc1(LN x)
packs a | b, LayerNorm eps 1e-5. The attention rotates the patch rows' q
and k by DINOv3's axial RoPE (as `transformers`' `DINOv3ViTModel` in eval
mode: patch centres in [-1, 1], inv_freq = 100^-(arange(0, 1, 4 / hd)),
angles 2 pi coord inv_freq laid out [y | x] and tiled twice,
`rotate_half`); the prefix rows (CLS and registers) are not rotated. It
returns every block's patch tokens (the prefix rows left out) and its CLS
importance: the CLS query's softmax over all keys, the patch columns kept,
averaged over heads. It imports nothing of the port and nothing of JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LN_EPS = 1e-5
ROPE_BASE = 100.0


def rope_cos_sin(grid: int, head_dim: int):
    """(cos, sin), each (grid^2, head_dim): the published layout, angles
    [y | x] tiled twice."""
    c = torch.arange(0.5, grid, dtype=torch.float32) / grid
    coords = 2.0 * torch.stack(torch.meshgrid(c, c, indexing="ij"), dim=-1).flatten(0, 1) - 1.0
    inv_freq = 1 / ROPE_BASE ** torch.arange(0, 1, 4 / head_dim, dtype=torch.float32)
    angles = (2 * math.pi * coords[:, :, None] * inv_freq[None, None, :]).flatten(1, 2)
    angles = angles.tile(2)
    return torch.cos(angles), torch.sin(angles)


def rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _linear(x, p, name):
    return F.linear(x, p[name + ".weight"], p[name + ".bias"])


def _ln(x, p, name, eps):
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], eps)


def attention(x, p, name, heads, cos, sin, prefix):
    """(the attention's output, the CLS importance (B, N - prefix)): q and k
    of the patch rows rotated by (cos, sin)."""
    b, n, d = x.shape
    hd = d // heads
    qkv = _linear(x, p, name + ".qkv")
    split = lambda t: t.reshape(b, n, heads, hd).transpose(1, 2)
    q, k, v = split(qkv[..., :d]), split(qkv[..., d:2 * d]), split(qkv[..., 2 * d:])
    rot = lambda t: torch.cat([t[:, :, :prefix], t[:, :, prefix:] * cos
                               + rotate_half(t[:, :, prefix:]) * sin], dim=2)
    q, k = rot(q), rot(k)
    attn = torch.softmax((q @ k.transpose(-1, -2)) * hd ** -0.5, dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(b, n, d)
    importance = attn[:, :, 0, prefix:].mean(dim=1)
    return _linear(out, p, name + ".proj"), importance


def swiglu_mlp(x, p, name):
    """fc2(silu(a) * b) of fc1's packed output a | b."""
    h = _linear(x, p, name + ".fc1")
    g = h.shape[-1] // 2
    return _linear(F.silu(h[..., :g]) * h[..., g:], p, name + ".fc2")


def forward(p: dict, images: torch.Tensor, *, patch_size: int, depth: int, heads: int,
            eps: float = LN_EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """(tokens (L, B, N, D), importance (L, B, N)) of every block, from
    (B, H, W, 3) float images, in float32; N the patches."""
    p = {k: v.float() for k, v in p.items()}
    b = images.shape[0]
    x = F.conv2d(images.float().permute(0, 3, 1, 2), p["patch_embed.proj.weight"],
                 p["patch_embed.proj.bias"], stride=patch_size)
    grid = x.shape[-1]
    x = x.flatten(2).transpose(1, 2)
    reg = p["register_tokens"]
    prefix = 1 + reg.shape[1]
    x = torch.cat([p["cls_token"].expand(b, 1, -1), reg.expand(b, -1, -1), x], dim=1)
    cos, sin = rope_cos_sin(grid, x.shape[-1] // heads)
    cos, sin = cos.to(x.device), sin.to(x.device)
    tokens, imps = [], []
    for i in range(depth):
        name = f"blocks.{i}"
        y, importance = attention(_ln(x, p, name + ".norm1", eps), p, name + ".attn", heads,
                                  cos, sin, prefix)
        x = x + y * p[name + ".ls1.gamma"]
        y = swiglu_mlp(_ln(x, p, name + ".norm2", eps), p, name + ".mlp")
        x = x + y * p[name + ".ls2.gamma"]
        tokens.append(x[:, prefix:])
        imps.append(importance)
    return torch.stack(tokens), torch.stack(imps)
