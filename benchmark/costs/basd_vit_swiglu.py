"""The work of one BASD train step with a SwiGLU ViT teacher (DINOv2's
ViT-g) and a ViT student: `costs/basd_vit.py`'s counts with the teacher's
MLP products those of the packed SwiGLU, and the gate kernel's least time.

A SwiGLU block's MLP multiplies each token by fc1 (2g, D) and the gate's
output by fc2 (D, g): 2 D 2g + 2 g D FLOPs a token, g = int(D r) // 2,
where the GELU MLP's are 4 D int(D r). The attention's calls and bound
read only the models' widths, heads and tokens, so they are
`basd_vit`'s. `tests/test_harness_costs.py` holds the teacher's forward
against `torch.utils.flop_counter` on the family's reference.
"""

from __future__ import annotations

from benchmark.costs import basd_vit, h100
from benchmark.costs.basd_vit import attention_bound_s, attention_calls, selector_k

__all__ = ["attention_bound_s", "attention_calls", "selector_k", "step_flops",
           "swiglu_forward_flops", "swiglu_gate_bound_s", "swiglu_gate_calls"]


def _half(d: int, mlp_ratio: float) -> int:
    return int(d * mlp_ratio) // 2


def swiglu_forward_flops(b, img, patch, d, depth, mlp_ratio) -> float:
    """Products of the SwiGLU ViT's forward on b images: the patch
    embedding, per block qkv, the scores, attention times values, proj,
    fc1 and fc2 (no head: a teacher's)."""
    n = (img // patch) ** 2
    t = n + 1
    g = _half(d, mlp_ratio)
    block = (2 * b * t * d * 3 * d + 4 * b * t * t * d + 2 * b * t * d * d
             + 2 * b * t * d * 2 * g + 2 * b * t * g * d)
    return 2 * b * n * 3 * patch * patch * d + depth * block


def step_flops(cfg: dict) -> float:
    """Products of one train step of the configuration."""
    s, t = cfg["student"], cfg["teacher"]
    b, img = cfg["data"]["batch_size"], s["img_size"]
    teacher = swiglu_forward_flops(b, img, t["patch_size"], t["embed_dim"], t["depth"],
                                   t["mlp_ratio"])
    student = basd_vit.vit_train_flops(b, img, s["patch_size"], s["embed_dim"], s["depth"],
                                       s["num_heads"], s["mlp_ratio"], s["num_classes"])
    sel = basd_vit.selector_flops(b, cfg["basd"]["num_extraction_points"], t["depth"],
                                  (img // s["patch_size"]) ** 2, (img // t["patch_size"]) ** 2,
                                  s["embed_dim"], t["embed_dim"], selector_k(cfg))
    return teacher + student + sel


def swiglu_gate_calls(cfg: dict) -> list[tuple[int, int]]:
    """(M, g) of each gate call in a step: one a teacher block, over the
    batch's tokens, CLS included."""
    s, t = cfg["student"], cfg["teacher"]
    m = cfg["data"]["batch_size"] * ((s["img_size"] // t["patch_size"]) ** 2 + 1)
    return [(m, _half(t["embed_dim"], t["mlp_ratio"]))] * t["depth"]


def swiglu_gate_bound_s(cfg: dict) -> float:
    """The least device seconds of the step's gate calls: each reads a and
    b and writes the product, 3 M g elements, over the memory bandwidth
    (its 4 M g FLOPs are nothing beside them)."""
    el = h100.BYTES[cfg["hardware"]["precision"]]
    return sum(3 * m * g * el for m, g in swiglu_gate_calls(cfg)) / h100.HBM_BYTES_PER_S
