"""The work of one BASD train step with a ViT teacher and a ViT student,
counted from the configuration's shapes: the yardstick of `step_mfu_pct`
and of the attention kernels' roofline shares.

`step_flops` counts the products (2 m n k for an (m, k) x (k, n) product)
that the algorithm needs: the teacher's forward, the student's forward
and backward (each product's two gradient products where both operands
carry a gradient, one where only one does; the patch convolution's image
gradient is not needed), and the selector's and the Procrustes loss's
products as the reference computes them, forward and backward. It leaves
out remat's recomputation, the elementwise work, the augmentation's
resampling and the eigendecompositions and MP-rank reductions, which are
not products. `tests/test_harness_costs.py` holds every term against
`torch.utils.flop_counter` on the plain reference at a small size.
"""

from __future__ import annotations

from benchmark.costs import h100

# the selector's subspace iteration (`reference/spectral.topk_basis_gram`)
G_ITERS, POLAR_ITERS = 6, 14
NS_SQRT_STEPS = 7


def vit_forward_flops(b, img, patch, d, depth, heads, mlp_ratio, classes=0) -> float:
    """Products of a ViT forward on b images: patch embedding, per block
    qkv, the scores, attention times values, proj, fc1 and fc2, the head."""
    n = (img // patch) ** 2
    t = n + 1
    hidden = int(d * mlp_ratio)
    block = (2 * b * t * d * 3 * d + 4 * b * t * t * d + 2 * b * t * d * d
             + 4 * b * t * d * hidden)
    return 2 * b * n * 3 * patch * patch * d + depth * block + 2 * b * d * classes


def vit_train_flops(b, img, patch, d, depth, heads, mlp_ratio, classes) -> float:
    """Forward and backward: three times the forward, less the patch
    convolution's image gradient."""
    n = (img // patch) ** 2
    fwd = vit_forward_flops(b, img, patch, d, depth, heads, mlp_ratio, classes)
    return 3 * fwd - 2 * b * n * 3 * patch * patch * d


def _topk(d, k, *, grad: bool) -> float:
    """`topk_basis_gram` on one (D, D) Gram: the subspace iterations, their
    Newton-Schulz orthonormalization, Rayleigh-Ritz and the basis; with
    `grad` the backward as well (the first iteration's start block carries
    none; the eigh backward's three K x K products)."""
    step = 2 * d * d * k
    polar = POLAR_ITERS * 4 * d * k * k
    rr = 2 * k * d * d + 2 * k * k * d
    basis = 2 * d * k * k
    fwd = G_ITERS * (step + polar) + rr + basis
    if not grad:
        return fwd
    return fwd + (step + (G_ITERS - 1) * 2 * step + G_ITERS * 2 * polar + 2 * rr
                  + 2 * basis + 6 * k ** 3)


def selector_flops(b, p, l, n_s, n_t, d_s, d_t, k) -> float:
    """The selector and the Procrustes loss at every extraction point,
    forward and backward (gradients to the student tokens and the
    temperatures)."""
    rows_s, rows_t = b * n_s, b * n_t
    teacher = (2 * l * rows_t * d_t * d_s + 2 * l * d_s * d_s * rows_t
               + l * _topk(d_s, k, grad=False))
    student = 2 * 2 * p * rows_s * d_s * d_s + 3 * 2 * p * d_s * d_s * rows_s \
        + p * _topk(d_s, k, grad=True)
    angles = 2 * 2 * p * l * k * k * d_s + 2 * p * l * k ** 3 + 4 * p * l * k ** 3
    mixing = 2 * 2 * p * l * (rows_t * d_t + rows_t)
    interp = 2 * 2 * b * n_t * n_s + 2 * 2 * b * n_s * n_t * n_t + 2 * 2 * b * n_s * n_t * n_s \
        if n_t != n_s else 0
    procrustes = (interp + 3 * 2 * b * n_s * n_s * d_s + 3 * 2 * b * n_t * n_t * d_t
                  + 2 * 3 * 2 * b * n_s * n_s + (2 + 8 * NS_SQRT_STEPS) * b * n_s ** 3
                  + 4 * b * n_s ** 3)
    return teacher + student + angles + mixing + p * procrustes


def selector_k(cfg: dict) -> int:
    s, t, basd = cfg["student"], cfg["teacher"], cfg["basd"]
    b = cfg["data"]["batch_size"]
    k = basd["subspace_k"] if basd["subspace_k"] is not None else min(96, s["embed_dim"] - 1)
    n_s = (s["img_size"] // s["patch_size"]) ** 2
    n_t = (s["img_size"] // t["patch_size"]) ** 2
    return min(k, s["embed_dim"] - 1, b * n_s, b * n_t)


def step_flops(cfg: dict) -> float:
    """Products of one train step of the configuration."""
    s, t = cfg["student"], cfg["teacher"]
    b, img = cfg["data"]["batch_size"], s["img_size"]
    teacher = vit_forward_flops(b, img, t["patch_size"], t["embed_dim"], t["depth"],
                                t["num_heads"], t["mlp_ratio"])
    student = vit_train_flops(b, img, s["patch_size"], s["embed_dim"], s["depth"],
                              s["num_heads"], s["mlp_ratio"], s["num_classes"])
    sel = selector_flops(b, cfg["basd"]["num_extraction_points"], t["depth"],
                         (img // s["patch_size"]) ** 2, (img // t["patch_size"]) ** 2,
                         s["embed_dim"], t["embed_dim"], selector_k(cfg))
    return teacher + student + sel


def attention_calls(cfg: dict, backward: bool) -> list[tuple[int, int, int, int, bool]]:
    """(B, tokens, heads, head_dim, stats) of each attention forward (every
    teacher block; every student block, twice under remat, whose backward
    runs the block's forward again) or backward (every student block) in a
    step. `stats` is whether the call needs the softmax's max and
    denominator: a forward only where a backward reads them (the student's
    recomputation under remat, its only forward without), every backward."""
    s, t = cfg["student"], cfg["teacher"]
    b, img = cfg["data"]["batch_size"], s["img_size"]
    shape = lambda m, p, stats: (b, (img // p) ** 2 + 1, m["num_heads"],
                                 m["embed_dim"] // m["num_heads"], stats)
    student = [shape(s, s["patch_size"], True)] * s["depth"]
    if backward:
        return student
    first = [shape(s, s["patch_size"], False)] * s["depth"] if cfg["hardware"]["remat"] else []
    return [shape(t, t["patch_size"], False)] * t["depth"] + first + student


def attention_bound_s(cfg: dict, backward: bool) -> float:
    """The least device seconds the step's attention forwards (or
    backwards) could take: per call the larger of its FLOPs over the bf16
    peak and its bytes over the memory bandwidth. Forward: 4 B H N^2 hd
    FLOPs; q, k, v read, o written, and, where a backward reads them, the
    (B, N, H) fp32 max and denominator written. Backward: 10 B H N^2 hd
    FLOPs; q, k, v, dO read, dq, dk, dv written, and the max, denominator
    and rowsum(dO o) read."""
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
