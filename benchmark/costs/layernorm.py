"""The teacher's LayerNorms in one train step, counted from the
configuration, and the least device time of the port's one-pass LayerNorm
kernel (`csrc/layernorm.cu`): the yardstick of `layernorm_roofline_pct`, for
every ViT family.

A frozen ViT teacher runs 2 depth + 1 LayerNorms a forward (each block's
norm1 and norm2, then the final norm), each over the whole residual stream:
the batch's CLS, register and patch rows at the teacher's width. The
student's LayerNorms run under autograd, on the composite, and are not
counted.
"""

from __future__ import annotations

from benchmark.costs import h100


def layernorm_calls(cfg: dict) -> list[tuple[int, int]]:
    """(rows M, width D) of each teacher LayerNorm in a step."""
    s, t = cfg["student"], cfg["teacher"]
    rows = cfg["data"]["batch_size"] * (
        (s["img_size"] // t["patch_size"]) ** 2 + 1 + t.get("num_register_tokens", 0))
    return [(rows, t["embed_dim"])] * (2 * t["depth"] + 1)


def layernorm_bound_s(cfg: dict) -> float:
    """The least device seconds of the step's teacher LayerNorms: each reads
    x and writes y once, in the configured precision, over the memory
    bandwidth (the fp32 weight and bias, D values each, and a dozen FLOPs a
    value are nothing beside them)."""
    el = h100.BYTES[cfg["hardware"]["precision"]]
    return sum(2 * m * d * el for m, d in layernorm_calls(cfg)) / h100.HBM_BYTES_PER_S
