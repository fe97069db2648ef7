"""The SwiGLU MLP's leaves, cut by one rule from the ViT draw of
`weights.make_weights`: the stage and the reference of a SwiGLU family
both call `cut`, so both hold the same tensors.

`make_weights` draws a GELU MLP of width h = int(D * mlp_ratio): fc1
(h, D) at N(0, 2 / D) and fc2 (D, h) at N(0, 2 / h). A packed SwiGLU
(timm's `SwiGLUPacked`) of that ratio has fc1 (2g, D) and fc2 (D, g),
g = h // 2. The cut keeps fc1's first 2g rows and bias entries, which are
already the SwiGLU leaf, and fc2's first g columns times sqrt(h / g),
which gives N(0, 2 / g): the same fan-in scale as every other kernel.
"""

from __future__ import annotations

import math

import torch


def packed_width(embed_dim: int, mlp_ratio: float) -> tuple[int, int]:
    """(h, g): the GELU draw's width and the gate's half width."""
    h = int(embed_dim * mlp_ratio)
    return h, h // 2


def cut(weights: dict[str, torch.Tensor], embed_dim: int,
        mlp_ratio: float) -> dict[str, torch.Tensor]:
    """`weights` with every block's MLP leaves cut to the SwiGLU's shapes."""
    h, g = packed_width(embed_dim, mlp_ratio)
    scale = math.sqrt(h / g)
    out = dict(weights)
    for name, w in weights.items():
        if name.endswith("mlp.fc1.weight") or name.endswith("mlp.fc1.bias"):
            out[name] = w[:2 * g]
        elif name.endswith("mlp.fc2.weight"):
            out[name] = w[:, :g] * scale
    return out
