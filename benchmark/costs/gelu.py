"""The erf GELU's calls in one train step, counted from the configuration,
and the least device time of the port's GELU kernels (`csrc/gelu.cu`): the
yardstick of `gelu_roofline_pct`, for every family.

A GELU MLP runs one GELU a block over the batch's tokens, CLS included, at
the MLP's width int(D r): every block of a GELU teacher once, forward only
(the teacher is frozen); every student block forward, once more under
remat (the backward runs the block's forward again), and backward once. A
SwiGLU teacher (`ffn` "swiglu") runs none.
"""

from __future__ import annotations

from benchmark.costs import h100


def _tokens(cfg: dict, model: dict) -> int:
    s = cfg["student"]
    return cfg["data"]["batch_size"] * ((s["img_size"] // model["patch_size"]) ** 2 + 1)


def gelu_calls(cfg: dict, backward: bool) -> list[tuple[int, int]]:
    """(values M, width h) of each GELU forward (or backward) in a step."""
    s, t = cfg["student"], cfg["teacher"]
    student = [(_tokens(cfg, s), int(s["embed_dim"] * s["mlp_ratio"]))] * s["depth"]
    if backward:
        return student
    teacher = [] if t.get("ffn", "gelu") != "gelu" else \
        [(_tokens(cfg, t), int(t["embed_dim"] * t["mlp_ratio"]))] * t["depth"]
    return teacher + student * (2 if cfg["hardware"]["remat"] else 1)


def gelu_bound_s(cfg: dict) -> float:
    """The least device seconds of the step's GELU calls: a forward reads x
    and writes y, a backward reads dy and x and writes dx, each value once,
    over the memory bandwidth (a few dozen FLOPs a value are nothing beside
    them)."""
    el = h100.BYTES[cfg["hardware"]["precision"]]
    fwd = sum(2 * m * h * el for m, h in gelu_calls(cfg, backward=False))
    bwd = sum(3 * m * h * el for m, h in gelu_calls(cfg, backward=True))
    return (fwd + bwd) / h100.HBM_BYTES_PER_S
