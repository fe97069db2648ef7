"""The SwiGLU ViT forward of DINOv2's ViT-g in plain torch and float32:
the reference that the CPU tests hold the port's `models/vit.py` (its
`SwiGLU` MLP and `ops.activations.swiglu_gate`) to.

Over a dict of timm/DINOv2-keyed tensors (the port's state-dict keys):
patch embedding, the CLS token and positions, then per block
x + ls1 * attn(LN x) and x + ls2 * fc2(silu(a) * b), where fc1(LN x) packs
a | b (timm's `SwiGLUPacked`, DINOv2's `SwiGLUFFNFused`). LayerNorm eps
1e-6. It returns every block's patch tokens (CLS stripped) and its CLS
importance: the CLS query's softmax over all keys, the patch columns kept,
averaged over heads. It imports no kernel of the port and nothing of JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_LN_EPS = 1e-6


def _linear(x, p, name):
    return F.linear(x, p[name + ".weight"], p[name + ".bias"])


def _ln(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], _LN_EPS)


def attention(x, p, name, heads):
    """(the attention's output, the CLS importance (B, N - 1))."""
    b, n, d = x.shape
    hd = d // heads
    scale = hd ** -0.5
    qkv = _linear(x, p, name + ".qkv")
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    split = lambda t: t.reshape(b, n, heads, hd).transpose(1, 2)
    attn = torch.softmax(split(q * scale) @ split(k).transpose(-1, -2), dim=-1)
    out = (attn @ split(v)).transpose(1, 2).reshape(b, n, d)
    importance = attn[:, :, 0, 1:].mean(dim=1)
    return _linear(out, p, name + ".proj"), importance


def swiglu_mlp(x, p, name):
    """fc2(silu(a) * b) of fc1's packed output a | b."""
    h = _linear(x, p, name + ".fc1")
    g = h.shape[-1] // 2
    return _linear(F.silu(h[..., :g]) * h[..., g:], p, name + ".fc2")


def forward(p: dict, images: torch.Tensor, *, patch_size: int, depth: int,
            heads: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(tokens (L, B, N, D), importance (L, B, N)) of every block, from
    (B, H, W, 3) float images, in float32."""
    p = {k: v.float() for k, v in p.items()}
    b = images.shape[0]
    x = F.conv2d(images.float().permute(0, 3, 1, 2), p["patch_embed.proj.weight"],
                 p["patch_embed.proj.bias"], stride=patch_size)
    x = x.flatten(2).transpose(1, 2)
    x = torch.cat([p["cls_token"].expand(b, 1, -1), x], dim=1) + p["pos_embed"]
    tokens, imps = [], []
    for i in range(depth):
        name = f"blocks.{i}"
        y, importance = attention(_ln(x, p, name + ".norm1"), p, name + ".attn", heads)
        x = x + y * p[name + ".ls1.gamma"]
        y = swiglu_mlp(_ln(x, p, name + ".norm2"), p, name + ".mlp")
        x = x + y * p[name + ".ls2.gamma"]
        tokens.append(x[:, 1:])
        imps.append(importance)
    return torch.stack(tokens), torch.stack(imps)
