"""The DINOv3 ViT's leaves, cut by one rule from the ViT draw of
`weights.make_weights`: the stage and the reference of the `basd_vit_rope`
family both call `cut`, so both hold the same tensors.

`make_weights` draws a ViT with a learned position table and a GELU MLP.
The cut keeps every block's SwiGLU leaves as `swiglu_weights.cut` makes
them (at mlp_ratio 4: fc1 (2g, D) as drawn, fc2's first g columns times
sqrt(2)), takes the register tokens (1, R, D) from the first R rows of the
drawn `pos_embed`, which is N(0, 0.02^2) as a register token's init, and
drops `pos_embed`: a RoPE ViT has no table. The qkv bias is drawn as zeros,
as a model without q/k/v bias holds it.
"""

from __future__ import annotations

import torch

from benchmark import swiglu_weights


def cut(weights: dict[str, torch.Tensor], teacher: dict) -> dict[str, torch.Tensor]:
    """`weights` (the draw of the configuration's `teacher`) as the RoPE
    ViT's leaves: views of the draw where they are its values as drawn."""
    r = teacher["num_register_tokens"]
    pos = weights["pos_embed"]
    if pos.shape[1] < r:
        raise ValueError(f"{r} register tokens need {r} rows of the drawn pos_embed, "
                         f"which has {pos.shape[1]}")
    out = swiglu_weights.cut(weights, teacher["embed_dim"], teacher["mlp_ratio"])
    del out["pos_embed"]
    out["register_tokens"] = pos[:, :r]
    return out
