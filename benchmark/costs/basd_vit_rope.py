"""The work of one BASD train step with a RoPE ViT teacher (DINOv3's
ViT-7B: register tokens, axial RoPE, a SwiGLU MLP) and a ViT student:
`costs/basd_vit_swiglu.py`'s counts with the teacher's blocks over its
CLS, register and patch rows, and the RoPE kernel's and the SwiGLU gate's
least times.

The teacher's products run over N = patches + 1 + R rows a block; the
rotation is elementwise and adds no product. The selector sees the patch
rows alone. The student's terms and the selector's are `basd_vit`'s.
"""

from __future__ import annotations

from benchmark.costs import basd_vit, h100
from benchmark.costs.basd_vit import selector_k

__all__ = ["attention_bound_s", "attention_calls", "rope_bound_s", "rope_calls",
           "rope_forward_flops", "selector_k", "step_flops", "swiglu_gate_bound_s",
           "swiglu_gate_calls"]


def _half(d: int, mlp_ratio: float) -> int:
    return int(d * mlp_ratio) // 2


def _rows(cfg: dict) -> int:
    """The teacher's rows an image: its patches, CLS and registers."""
    t = cfg["teacher"]
    return (cfg["student"]["img_size"] // t["patch_size"]) ** 2 + 1 + t["num_register_tokens"]


def rope_forward_flops(b, img, patch, d, depth, mlp_ratio, registers) -> float:
    """Products of the RoPE ViT's forward on b images: the patch embedding,
    per block qkv, the scores, attention times values, proj, fc1 and fc2 of
    the packed SwiGLU, over patches, CLS and registers (no head: a
    teacher's)."""
    n = (img // patch) ** 2
    t = n + 1 + registers
    g = _half(d, mlp_ratio)
    block = (2 * b * t * d * 3 * d + 4 * b * t * t * d + 2 * b * t * d * d
             + 2 * b * t * d * 2 * g + 2 * b * t * g * d)
    return 2 * b * n * 3 * patch * patch * d + depth * block


def step_flops(cfg: dict) -> float:
    """Products of one train step of the configuration."""
    s, t = cfg["student"], cfg["teacher"]
    b, img = cfg["data"]["batch_size"], s["img_size"]
    teacher = rope_forward_flops(b, img, t["patch_size"], t["embed_dim"], t["depth"],
                                 t["mlp_ratio"], t["num_register_tokens"])
    student = basd_vit.vit_train_flops(b, img, s["patch_size"], s["embed_dim"], s["depth"],
                                       s["num_heads"], s["mlp_ratio"], s["num_classes"])
    sel = basd_vit.selector_flops(b, cfg["basd"]["num_extraction_points"], t["depth"],
                                  (img // s["patch_size"]) ** 2, (img // t["patch_size"]) ** 2,
                                  s["embed_dim"], t["embed_dim"], selector_k(cfg))
    return teacher + student + sel


def attention_calls(cfg: dict, backward: bool) -> list[tuple[int, int, int, int, bool]]:
    """`basd_vit.attention_calls` with the teacher's calls over its N rows."""
    t, b = cfg["teacher"], cfg["data"]["batch_size"]
    calls = basd_vit.attention_calls(cfg, backward)
    if backward:
        return calls
    teacher = (b, _rows(cfg), t["num_heads"], t["embed_dim"] // t["num_heads"], False)
    return [teacher] * t["depth"] + calls[t["depth"]:]


def attention_bound_s(cfg: dict, backward: bool) -> float:
    """`basd_vit.attention_bound_s`'s least time over these calls."""
    el = h100.BYTES[cfg["hardware"]["precision"]]
    total = 0.0
    for b, n, h, hd, stats in attention_calls(cfg, backward):
        d = h * hd
        if backward:
            flops, nbytes = 10 * b * h * n * n * hd, 7 * b * n * d * el + 3 * b * n * h * 4
        else:
            flops, nbytes = 4 * b * h * n * n * hd, 4 * b * n * d * el + stats * 2 * b * n * h * 4
        total += max(flops / h100.BF16_FLOPS, nbytes / h100.HBM_BYTES_PER_S)
    return total


def rope_calls(cfg: dict) -> list[tuple[int, int, int]]:
    """(B, N, D) of each RoPE call in a step: one a teacher block, over its
    CLS, register and patch rows."""
    t = cfg["teacher"]
    return [(cfg["data"]["batch_size"], _rows(cfg), t["embed_dim"])] * t["depth"]


def rope_bound_s(cfg: dict) -> float:
    """The least device seconds of the step's RoPE calls: each reads q and k
    and writes them rotated, 4 B N D elements, 8 B N D bytes in bf16, over
    the memory bandwidth (its few FLOPs an element are nothing beside
    them; the (N, hd) table stays in cache)."""
    el = h100.BYTES[cfg["hardware"]["precision"]]
    return sum(4 * b * n * d * el for b, n, d in rope_calls(cfg)) / h100.HBM_BYTES_PER_S


def swiglu_gate_calls(cfg: dict) -> list[tuple[int, int]]:
    """(M, g) of each gate call in a step: one a teacher block, over its
    CLS, register and patch rows."""
    t = cfg["teacher"]
    m = cfg["data"]["batch_size"] * _rows(cfg)
    return [(m, _half(t["embed_dim"], t["mlp_ratio"]))] * t["depth"]


def swiglu_gate_bound_s(cfg: dict) -> float:
    """`basd_vit_swiglu.swiglu_gate_bound_s` over these calls: a and b read,
    the product written, 3 M g elements, over the memory bandwidth."""
    el = h100.BYTES[cfg["hardware"]["precision"]]
    return sum(3 * m * g * el for m, g in swiglu_gate_calls(cfg)) / h100.HBM_BYTES_PER_S
