"""The BASD train step with a SwiGLU ViT teacher (DINOv2's ViT-g) and a
ViT student, in plain torch and float32 with TF32 off: the reference that
decides `correct` for the `basd_vit_swiglu` family.

`reference/basd_vit.py`'s step (its augmentation, selector, Procrustes
loss, CE, UW-SO and ScheduleFree, imported from there) with the teacher's
blocks computing x + ls2 * fc2(silu(a) * b), where fc1 packs a | b. The
teacher's MLP leaves are cut from the harness's ViT draw by
`swiglu_weights.cut`, the rule the stage applies. It imports nothing of
the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark import swiglu_weights
from benchmark.reference import augment
from benchmark.reference.basd_vit import (
    ScheduleFree,
    cross_entropy,
    extraction_points,
    procrustes_mixed,
    select_and_mix,
    selector_k,
    selector_projections,
)
from benchmark.reference.vit import _attention, _linear, _ln, draw_drop_path, low, vit_forward

_EPS = torch.finfo(torch.float32).eps


def swiglu_teacher_forward(p, images, *, patch_size, depth, heads, fp8=False):
    """(tokens (L, B, N, D), importance (L, B, N)) of every block of the
    SwiGLU ViT with LayerScale, from (B, H, W, 3) float images. With `fp8`
    every value the program holds in bf16 is rounded to float8 e4m3 as
    `reference/vit.py` rounds it: here also fc1's packed output and the
    gate's product. Each block's tokens are copied into one stack as the
    block ends, so no block's whole residual stream is kept (at ViT-g's
    40 blocks, batch 256, float32: 16 GB a copy)."""
    b = images.shape[0]
    x = low(F.conv2d(low(images.permute(0, 3, 1, 2), fp8),
                     low(p["patch_embed.proj.weight"], fp8),
                     low(p["patch_embed.proj.bias"], fp8), stride=patch_size), fp8)
    x = x.flatten(2).transpose(1, 2)
    x = low(torch.cat([low(p["cls_token"], fp8).expand(b, 1, -1), x], dim=1)
            + low(p["pos_embed"], fp8), fp8)
    tokens = x.new_empty((depth, b, x.shape[1] - 1, x.shape[2]))
    imps = []
    for i in range(depth):
        name = f"blocks.{i}"
        y, importance = _attention(_ln(x, p, name + ".norm1", fp8), p, name + ".attn", heads,
                                   fp8)
        x = low(x + low(y * low(p[name + ".ls1.gamma"], fp8), fp8), fp8)
        h = _linear(_ln(x, p, name + ".norm2", fp8), p, name + ".mlp.fc1", fp8)
        g = h.shape[-1] // 2
        y = _linear(low(F.silu(h[..., :g]) * h[..., g:], fp8), p, name + ".mlp.fc2", fp8)
        x = low(x + low(y * low(p[name + ".ls2.gamma"], fp8), fp8), fp8)
        tokens[i] = x[:, 1:]
        imps.append(importance)
    return tokens, torch.stack(imps)


def run_steps(cfg: dict, student_w: dict, teacher_w: dict, batches, *, step_seed: int,
              selector_seed: int, k: int, fp8: bool = False, fault: str | None = None):
    """`reference/basd_vit.py:run_steps` with the SwiGLU teacher: the same
    arguments, faults and readings."""
    s, t, d, tr, basd = (cfg["student"], cfg["teacher"], cfg["data"], cfg["training"],
                         cfg["basd"])
    if t.get("ffn") != "swiglu":
        raise ValueError(f"the teacher's MLP is {t.get('ffn')!r}, not swiglu")
    dev = next(iter(student_w.values())).device
    params = {n: w.detach().clone().requires_grad_(True) for n, w in student_w.items()}
    teacher = {n: w.detach() for n, w in
               swiglu_weights.cut(teacher_w, t["embed_dim"], t["mlp_ratio"]).items()}
    log_t, proj_s, proj_t = selector_projections(selector_seed, basd["num_extraction_points"],
                                                 s["embed_dim"], t["embed_dim"])
    log_t, proj_s, proj_t = log_t.to(dev).requires_grad_(True), proj_s.to(dev), proj_t.to(dev)
    names = list(params) + ["selector.log_temperatures"]
    leaves = list(params.values()) + [log_t]
    start = {n: p.detach().cpu().clone() for n, p in zip(names, leaves)}
    opt = ScheduleFree(leaves, tr["learning_rate"], tr["weight_decay"], tr["warmup_steps"])
    gen = torch.Generator(device=dev).manual_seed(step_seed)
    points = extraction_points(s["depth"], basd["num_extraction_points"])
    img = s["img_size"]
    steps, grads, grad_norms = [], None, None
    for i, (images_u8, labels) in enumerate(batches):
        images_u8, labels = images_u8.to(dev), labels.to(dev)
        b = images_u8.shape[0]
        draws = augment.sample_step_draws(gen, b)
        clean, student_in, targets = augment.views(
            images_u8, labels, draws, img_size=img, crop_ratio=d["crop_ratio"],
            teacher_stats=(tuple(t["norm_mean"]), tuple(t["norm_std"])),
            dataset_stats=tuple(map(tuple, d["dataset_stats"])), num_classes=s["num_classes"])
        dp = draw_drop_path(gen, b, s["depth"], s["drop_path_rate"], dev)
        if fault == "half_batch":
            h = b // 2
            clean, student_in, targets, labels = clean[:h], student_in[:h], targets[:h], labels[:h]
            dp = [tuple(None if u is None else u[:h] for u in pair) for pair in dp]
        with torch.no_grad():
            t_tok, t_imp = swiglu_teacher_forward(teacher, clean, patch_size=t["patch_size"],
                                                  depth=t["depth"], heads=t["num_heads"],
                                                  fp8=fp8)
        logits, s_tok, _ = vit_forward(
            params, student_in, patch_size=s["patch_size"], depth=s["depth"],
            heads=s["num_heads"], capture=points, drop_path_rate=s["drop_path_rate"],
            draws=dp, fp8=fp8)
        ce = cross_entropy(logits, targets, tr["label_smoothing"])
        kk = selector_k(k, s["embed_dim"], b * s_tok.shape[2], b * t_tok.shape[2])
        mixed, mixed_imp, weights, tau, ranks = select_and_mix(
            log_t, proj_s, proj_t, s_tok, t_tok, t_imp, kk, fp8, fault)
        geo = torch.stack([procrustes_mixed(s_tok[j], mixed[j], mixed_imp[j])
                           for j in range(len(points))]).mean()
        losses = torch.stack([ce, geo])
        inv = 1.0 / torch.clamp(losses.detach(), min=_EPS)
        loss = torch.sum(inv / inv.sum() * losses)
        loss.backward()
        if fault != "frozen":
            opt.step()
        else:
            for p in leaves:
                p.grad = None
        steps.append({"loss": loss.detach(), "ce_loss": ce.detach(), "geo_loss": geo.detach(),
                      "mixing_weights": weights.detach(), "temperatures": tau.detach(),
                      "mp_ranks": ranks})
        if i == 0:
            grads = {n: torch.sqrt(v / (1.0 - opt.b2)).cpu() for n, v in zip(names, opt.v)}
            grad_norms = {n: float(g.double().norm()) for n, g in grads.items()}
    return {"steps": [{k2: v.cpu() for k2, v in m.items()} for m in steps],
            "grad_norms": grad_norms, "grads": grads, "start": start,
            "params": {n: p.detach().cpu() for n, p in zip(names, leaves)}}
