"""The BASD train step with a RoPE ViT teacher (DINOv3's ViT-7B/16) and a
ViT student, in plain torch and float32 with TF32 off: the reference that
decides `correct` for the `basd_vit_rope` family.

`reference/basd_vit.py`'s step (its augmentation, selector, Procrustes
loss, CE, UW-SO and ScheduleFree, imported from there) with the teacher's
blocks as DINOv3 computes them: [CLS | registers | patches], LayerNorm eps
from the configuration (1e-5), q and k of the patch rows rotated by axial
RoPE (base 100, patch centres in [-1, 1], inv_freq = 100^-(arange(0, 1,
4 / hd)), angles 2 pi coord inv_freq laid out [y | x] and tiled twice,
`rotate_half`; eval mode: no shift, jitter or rescale), the prefix rows not
rotated, LayerScale, and x + ls2 * fc2(silu(a) * b) where fc1 packs a | b.
The captured tokens leave out the prefix rows, and the CLS importance keeps
the patch columns of the CLS row's softmax over all keys. The teacher's
leaves are cut from the harness's ViT draw by `rope_weights.cut`, the rule
the stage applies. It imports nothing of the port.

Departures from the published model, each the configuration's `assumed`:
random weights with LayerScale 1, register tokens drawn N(0, 0.02^2), the
fused qkv's bias held at zero where the published model has none, no mask
token and no final norms (a teacher's tokens are its blocks' outputs).

Memory: at the cell's size the drawn weights take 35 GiB of the card and
the 40 layers' tokens 30.6 GiB in float32, more than fits beside the
student's saved activations. The stack is therefore kept in host memory,
in blocks of one layer: the teacher runs once, each block's tokens copied
to the host as the block ends, their projection onto the selector's
`proj_t` (all the selector's ranks, bases and distances need) made on the
card; the mix (`HostMix`) streams the layers back to the card one at a time
to add them up with the mixing weights, and its backward streams them
again for the weights' gradient.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark import rope_weights
from benchmark.reference import augment, spectral
from benchmark.reference.basd_vit import (
    ScheduleFree,
    cross_entropy,
    extraction_points,
    procrustes_mixed,
    selector_k,
    selector_projections,
)
from benchmark.reference.vit import _linear, draw_drop_path, low, vit_forward

_EPS = torch.finfo(torch.float32).eps
ROPE_BASE = 100.0


def rope_cos_sin(grid: int, head_dim: int, device):
    """(cos, sin), each (grid^2, head_dim): the published layout."""
    c = torch.arange(0.5, grid, dtype=torch.float32) / grid
    coords = 2.0 * torch.stack(torch.meshgrid(c, c, indexing="ij"), dim=-1).flatten(0, 1) - 1.0
    inv_freq = 1 / ROPE_BASE ** torch.arange(0, 1, 4 / head_dim, dtype=torch.float32)
    angles = (2 * math.pi * coords[:, :, None] * inv_freq[None, None, :]).flatten(1, 2).tile(2)
    return torch.cos(angles).to(device), torch.sin(angles).to(device)


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _ln(x, p, name, eps, fp8):
    out = F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], eps)
    return low(out, fp8)


def _attention(x, p, name, heads, cos, sin, prefix, fp8):
    """(the attention's output, the CLS importance (B, N - prefix))."""
    b, n, d = x.shape
    hd = d // heads
    scale = hd ** -0.5
    qkv = _linear(x, p, name + ".qkv", fp8)
    split = lambda t: t.reshape(b, n, heads, hd).transpose(1, 2)
    q, k, v = split(qkv[..., :d]), split(qkv[..., d:2 * d]), split(qkv[..., 2 * d:])
    rot = lambda t: torch.cat([t[:, :, :prefix], t[:, :, prefix:] * cos
                               + _rotate_half(t[:, :, prefix:]) * sin], dim=2)
    q, k = low(rot(q) * scale, fp8), low(rot(k), fp8)
    attn = low(torch.softmax(q @ k.transpose(-1, -2), dim=-1), fp8)
    out = low((attn @ v).transpose(1, 2).reshape(b, n, d), fp8)
    cls_logits = (k * q[:, :, :1]).sum(-1)  # (B, H, N)
    importance = torch.softmax(cls_logits, dim=-1)[:, :, prefix:].mean(dim=1)
    return _linear(out, p, name + ".proj", fp8), importance


def rope_teacher_forward(p, images, *, patch_size, depth, heads, eps, proj_t, stack=None,
                         fp8=False):
    """(z (L, B N, D_s): each block's patch tokens times proj_t^T,
    importance (L, B, N)) of the RoPE ViT from (B, H, W, 3) float images;
    each block's patch tokens (B, N, D) go into `stack[i]` (L, B, N, D,
    in host memory) where it is given. With `fp8` every value the program
    holds in bf16 is rounded to float8 e4m3 as `reference/vit.py` rounds
    it, here also q and k after the rotation and the gate's product."""
    b = images.shape[0]
    x = low(F.conv2d(low(images.permute(0, 3, 1, 2), fp8),
                     low(p["patch_embed.proj.weight"], fp8),
                     low(p["patch_embed.proj.bias"], fp8), stride=patch_size), fp8)
    grid = x.shape[-1]
    x = x.flatten(2).transpose(1, 2)
    reg = low(p["register_tokens"], fp8)
    prefix = 1 + reg.shape[1]
    x = torch.cat([low(p["cls_token"], fp8).expand(b, 1, -1), reg.expand(b, -1, -1), x], dim=1)
    cos, sin = rope_cos_sin(grid, x.shape[-1] // heads, x.device)
    proj = low(proj_t, fp8).T
    zs, imps = [], []
    for i in range(depth):
        name = f"blocks.{i}"
        y, importance = _attention(_ln(x, p, name + ".norm1", eps, fp8), p, name + ".attn",
                                   heads, cos, sin, prefix, fp8)
        x = low(x + low(y * low(p[name + ".ls1.gamma"], fp8), fp8), fp8)
        h = _linear(_ln(x, p, name + ".norm2", eps, fp8), p, name + ".mlp.fc1", fp8)
        g = h.shape[-1] // 2
        y = _linear(low(F.silu(h[..., :g]) * h[..., g:], fp8), p, name + ".mlp.fc2", fp8)
        x = low(x + low(y * low(p[name + ".ls2.gamma"], fp8), fp8), fp8)
        tok = x[:, prefix:]
        if stack is not None:
            stack[i].copy_(tok)
        zs.append(tok.reshape(-1, tok.shape[-1]) @ proj)
        imps.append(importance)
    return torch.stack(zs), torch.stack(imps)


class HostMix(torch.autograd.Function):
    """(P, B, N, D) = sum over layers l of weights[:, l] times the layer's
    tokens, which `stack` (L, B, N, D) holds in host memory: each layer
    brought to the card in turn, forward and backward (the weights'
    gradient is each layer's inner product with the output's gradient)."""

    @staticmethod
    def forward(ctx, weights, stack):
        ctx.stack = stack
        p = weights.shape[0]
        out = torch.zeros((p,) + tuple(stack.shape[1:]), dtype=torch.float32,
                          device=weights.device)
        for i in range(stack.shape[0]):
            tok = stack[i].to(weights.device)
            out.addcmul_(weights[:, i].reshape(p, 1, 1, 1), tok.unsqueeze(0))
        return out

    @staticmethod
    def backward(ctx, grad):
        stack = ctx.stack
        flat = grad.reshape(grad.shape[0], -1)
        dw = torch.stack([flat @ stack[i].to(grad.device).reshape(-1)
                          for i in range(stack.shape[0])], dim=1)
        return dw, None


def select_and_mix(log_t, proj_s, z_t, stack, t_imp, s_tokens, k, fp8=False, fault=None):
    """`reference/basd_vit.py:select_and_mix` with the teacher's tokens
    given as their projections `z_t` (L, B N, D_s) and the host `stack`."""
    p, b, n_s, d_s = s_tokens.shape
    l, _, n_t, d_t = stack.shape
    with torch.no_grad():
        m_t = b * n_t
        g_t = z_t.transpose(-1, -2) @ z_t
        mu_t = z_t.mean(dim=-2)
        short = 1 if fault == "mp_rank_short" else 0
        ranks = torch.clamp(spectral.mp_rank_gram(g_t, m_t) - short, 1, k)
        g_ct = g_t - m_t * mu_t[:, :, None] * mu_t[:, None, :]
        basis_t, svals_t = spectral.topk_basis_gram(g_ct, k)
    z_s = s_tokens.reshape(p, b * n_s, d_s) @ proj_s.T
    m_s = b * n_s
    g_s = z_s.transpose(-1, -2) @ z_s
    mu_s = z_s.mean(dim=-2)
    basis_s, _ = spectral.topk_basis_gram(g_s - m_s * mu_s[:, :, None] * mu_s[:, None, :], k)
    d2 = spectral.principal_angle_distance(basis_s[:, None], basis_t[None], svals_t[None],
                                           ranks[None])
    if fault == "flat_selector":
        d2 = torch.zeros_like(d2)
    tau = F.softplus(log_t)
    weights = torch.softmax(-d2 / tau[:, None], dim=-1)
    mixed = low(HostMix.apply(weights, stack), fp8)
    mixed_imp = (weights @ t_imp.reshape(l, -1)).reshape(p, b, n_t)
    return mixed, mixed_imp, weights, tau, ranks


def run_steps(cfg: dict, student_w: dict, teacher_w: dict, batches, *, step_seed: int,
              selector_seed: int, k: int, fp8: bool = False, fault: str | None = None):
    """`reference/basd_vit.py:run_steps` with the RoPE teacher: the same
    arguments, faults and readings."""
    s, t, d, tr, basd = (cfg["student"], cfg["teacher"], cfg["data"], cfg["training"],
                         cfg["basd"])
    if t.get("positions") != "rope" or t.get("ffn") != "swiglu":
        raise ValueError(f"the teacher's positions and MLP are {t.get('positions')!r} and "
                         f"{t.get('ffn')!r}, not rope and swiglu")
    dev = next(iter(student_w.values())).device
    params = {n: w.detach().clone().requires_grad_(True) for n, w in student_w.items()}
    teacher = {n: w.detach() for n, w in rope_weights.cut(teacher_w, t).items()}
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
    n_t = (img // t["patch_size"]) ** 2
    stack = None
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
        if stack is None:  # host memory, reused by every step
            stack = torch.empty((t["depth"], clean.shape[0], n_t, t["embed_dim"]),
                                dtype=torch.float32)
        with torch.no_grad():
            z_t, t_imp = rope_teacher_forward(
                teacher, clean, patch_size=t["patch_size"], depth=t["depth"],
                heads=t["num_heads"], eps=t["ln_eps"], proj_t=proj_t, stack=stack, fp8=fp8)
        logits, s_tok, _ = vit_forward(
            params, student_in, patch_size=s["patch_size"], depth=s["depth"],
            heads=s["num_heads"], capture=points, drop_path_rate=s["drop_path_rate"],
            draws=dp, fp8=fp8)
        ce = cross_entropy(logits, targets, tr["label_smoothing"])
        kk = selector_k(k, s["embed_dim"], b * s_tok.shape[2], b * n_t)
        mixed, mixed_imp, weights, tau, ranks = select_and_mix(
            log_t, proj_s, z_t, stack, t_imp, s_tok, kk, fp8, fault)
        del z_t
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
