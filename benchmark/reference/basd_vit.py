"""The BASD train step with a ViT teacher and a ViT student, in plain
torch and float32 with TF32 off: the reference that decides `correct`.

It works out again what the port derives: the augmentation's draws from
the step's generator seed, both views and the mixed targets, the
teacher's intermediates, the student forward with its drop-path draws, the
selector (MP ranks, K-capped subspaces, masked principal angles, softmax
mixing over teacher layers), the importance-weighted Procrustes loss at
each extraction point, CE with label smoothing, UW-SO, the backward and
the ScheduleFree AdamW update. It imports nothing of the port; it takes
the raw uint8 batches and the weights that the harness made, never the
port's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import augment, spectral
from benchmark.reference.vit import draw_drop_path, low, vit_forward

_F32 = torch.float32
_EPS = torch.finfo(torch.float32).eps


def extraction_points(depth: int, num_points: int) -> tuple[int, ...]:
    if num_points == 1:
        return (depth - 1,)
    return tuple(round(i * (depth - 1) / (num_points - 1)) for i in range(num_points))


def selector_k(subspace_k, d_s, rows_s, rows_t) -> int:
    """K: the configured cap (96 where it is null) below D_s and the rows."""
    if subspace_k is None:
        subspace_k = min(96, d_s - 1)
    return min(subspace_k, d_s - 1, rows_s, rows_t)


def selector_projections(seed: int, num_points: int, d_s: int, d_t: int):
    """(log-temperatures with softplus = 1, proj_s (D_s, D_s) orthogonal,
    proj_t (D_s, D_t) semi-orthogonal), drawn on the CPU from `seed`."""
    g = torch.Generator().manual_seed(seed)
    ortho = lambda shape: torch.nn.init.orthogonal_(torch.empty(shape, dtype=_F32),
                                                    generator=g)
    proj_s = ortho((d_s, d_s))
    proj_t = ortho((d_s, d_t))
    log_t = torch.full((num_points,), math.log(math.e - 1.0), dtype=_F32)
    return log_t, proj_s, proj_t


def select_and_mix(log_t, proj_s, proj_t, s_tokens, t_tokens, t_imp, k, fp8=False,
                   fault=None):
    p, b, n_s, d_s = s_tokens.shape
    l, _, n_t, d_t = t_tokens.shape
    with torch.no_grad():
        z_t = t_tokens.reshape(l, b * n_t, d_t) @ low(proj_t, fp8).T
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
    mixed = low((weights @ t_tokens.reshape(l, -1)).reshape(p, b, n_t, d_t), fp8)
    mixed_imp = (weights @ t_imp.reshape(l, -1)).reshape(p, b, n_t)
    return mixed, mixed_imp, weights, tau, ranks


def _center_scale_gram(g, w):
    a = (g @ w[..., None])[..., 0]
    c = torch.sum(w * a, dim=-1)
    g_c = g - a[:, :, None] - a[:, None, :] + c[:, None, None]
    ws = torch.sqrt(w)
    g_w = g_c * ws[:, :, None] * ws[:, None, :]
    lam = 1e-6 * torch.sum(w * torch.diagonal(g, dim1=-2, dim2=-1), dim=-1)
    eye = torch.eye(g.shape[-1], dtype=_F32, device=g.device)
    return g_w, g_w + lam[:, None, None] * eye


def _trace(g):
    return torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)


def procrustes_mixed(s_tokens, mixed, importance):
    """tr(S_w^T S_w) + tr(T_w^T T_w) - 2 ||S_w^T T_w||_nuc, batch mean, on
    the token Grams, with the teacher tokens' Gram interpolated to the
    student's token grid."""
    n_s, n_t = s_tokens.shape[1], mixed.shape[1]
    if n_s > min(s_tokens.shape[-1], mixed.shape[-1]):
        raise ValueError("the reference takes the Procrustes loss's token-Gram route only")
    a = torch.from_numpy(spectral.linear_interp_matrix(n_s, n_t)).to(s_tokens.device)
    w = importance if n_t == n_s else importance @ a.T
    w = w / w.sum(dim=-1, keepdim=True)
    g_s, g_s_r = _center_scale_gram(s_tokens @ s_tokens.transpose(-1, -2), w)
    g_mix = mixed @ mixed.transpose(-1, -2)
    if n_t != n_s:
        g_mix = a @ g_mix @ a.T
    g_t, g_t_r = _center_scale_gram(g_mix, w)
    nuc = spectral.nuclear_norm_pair_gram(g_s_r, g_t_r)
    return torch.mean(_trace(g_s) + _trace(g_t) - 2.0 * nuc)


def cross_entropy(logits, targets, smoothing):
    c = logits.shape[-1]
    t = (1.0 - smoothing) * targets + smoothing / c
    return -torch.mean(torch.sum(t * torch.log_softmax(logits, dim=-1), dim=-1))


class ScheduleFree:
    """Schedule-Free AdamW (Defazio et al. 2024) on the gradient point y:
    gamma_t = lr min(1, t / warmup) sqrt(1 - b2^t), c_t = gamma_t^2 /
    sum gamma_i^2, v = b2 v + (1 - b2) g^2, u = g / (sqrt v + eps) + wd y,
    y += c_t (z - y) + gamma_t (b1 (1 - c_t) - 1) u, z -= gamma_t u."""

    def __init__(self, params, lr, weight_decay, warmup, b1=0.9, b2=0.999, eps=1e-8):
        self.params = params
        self.lr, self.wd, self.warmup = lr, weight_decay, warmup
        self.b1, self.b2, self.eps = b1, b2, eps
        self.z = [p.detach().clone() for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t, self.weight_sum = 0, 0.0

    @torch.no_grad()
    def step(self):
        self.t += 1
        sched = min(1.0, self.t / max(self.warmup, 1)) if self.warmup else 1.0
        gamma = self.lr * sched * (1.0 - self.b2 ** self.t) ** 0.5
        self.weight_sum += gamma ** 2
        ckp1 = gamma ** 2 / self.weight_sum if self.weight_sum > 0 else 0.0
        y_u = gamma * (self.b1 * (1.0 - ckp1) - 1.0)
        for p, z, v in zip(self.params, self.z, self.v):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            v.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            u = g / (v.sqrt() + self.eps) + self.wd * p
            y_new = p + ckp1 * (z - p) + y_u * u
            z.sub_(gamma * u)
            p.copy_(y_new)
            p.grad = None


def run_steps(cfg: dict, student_w: dict, teacher_w: dict, batches, *, step_seed: int,
              selector_seed: int, k: int, fp8: bool = False, fault: str | None = None):
    """The first len(batches) steps from the given weights. Returns each
    step's metrics, each leaf's gradient after step 1 (its magnitude from
    the second moment, as the optimizer holds it) and its norm, and each
    leaf's parameters
    at the start and after the last step, by the port's parameter names.

    `fault` plants one of the faults the comparison has to catch, in the
    reference put in the program's place: "half_batch" (the loss over the
    first half of each batch), "frozen" (no update), "flat_selector" (every
    principal-angle distance taken as 0, so the mixing weights stay
    uniform), "mp_rank_short" (every teacher layer's MP rank one short
    before the cap at K)."""
    s, t, d, tr, basd = (cfg["student"], cfg["teacher"], cfg["data"], cfg["training"],
                         cfg["basd"])
    dev = next(iter(student_w.values())).device
    params = {n: w.detach().clone().requires_grad_(True) for n, w in student_w.items()}
    teacher = {n: w.detach() for n, w in teacher_w.items()}
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
            _, t_tok, t_imp = vit_forward(
                teacher, clean, patch_size=t["patch_size"], depth=t["depth"],
                heads=t["num_heads"], capture=range(t["depth"]),
                layer_scale=t.get("layer_scale_init") is not None, head=False, fp8=fp8)
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
