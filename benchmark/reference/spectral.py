"""The selector's and the Procrustes loss's spectral algebra in plain
torch, float32: a frozen copy of the port's plain paths, with every
symmetric eigendecomposition taken by `torch.linalg.eigh` and the
Marchenko-Pastur rank counted from `torch.linalg.eigvalsh`.

The backward rules are the algorithm's own: the eigh backward is the
transpose of its gap-regularized JVP, the singular values' and the
Newton-Schulz square root's are the closed forms the algorithm defines.
"""

from __future__ import annotations

import numpy as np
import torch

_F32 = torch.float32
_TINY = torch.finfo(torch.float32).tiny
_EPS = torch.finfo(torch.float32).eps


class _EighSafe(torch.autograd.Function):
    """eigh (ascending); backward sym(v M v^T), M = diag(gw) + F o (v^T gv),
    F_ij = gap/(gap^2 + eps^2), gap_ij = w_j - w_i, eps = 1e-6 max|w|."""

    @staticmethod
    def forward(ctx, a):
        w, v = torch.linalg.eigh(a)
        ctx.save_for_backward(w, v)
        return w, v

    @staticmethod
    def backward(ctx, gw, gv):
        w, v = ctx.saved_tensors
        d = w.shape[-1]
        m = torch.zeros_like(v)
        if gv is not None:
            gap = w[..., None, :] - w[..., :, None]
            scale = w.abs().amax(dim=-1, keepdim=True)[..., None]
            eps = 1e-6 * torch.clamp(scale, min=1e-30)
            f = gap / (gap * gap + eps * eps)
            f = f * (1.0 - torch.eye(d, dtype=w.dtype, device=w.device))
            m = f * (v.transpose(-1, -2) @ gv)
        if gw is not None:
            m = m + torch.diag_embed(gw)
        g = v @ m @ v.transpose(-1, -2)
        return (g + g.transpose(-1, -2)) * 0.5


def eigh_desc(gram):
    gram = (gram + gram.transpose(-1, -2)) * 0.5
    w, v = _EighSafe.apply(gram)
    return w.flip(-1), v.flip(-1)


def mp_rank_gram(gram, m):
    """Marchenko-Pastur rank of M samples from their uncentered Gram:
    sigma^2 the median eigenvalue (mean of the middle pair), rank the
    count above sigma^2 (1 + sqrt(d / m))^2."""
    d = gram.shape[-1]
    cov = gram.to(_F32) / m
    eigvals = torch.linalg.eigvalsh((cov + cov.transpose(-1, -2)) * 0.5)
    sigma2 = 0.5 * (eigvals[..., (d - 1) // 2] + eigvals[..., d // 2])
    lambda_plus = sigma2 * (1.0 + (d / m) ** 0.5) ** 2
    return torch.sum(eigvals > lambda_plus[..., None], dim=-1)


def _safe_inverse(sigma, g):
    scale = sigma.amax(dim=-1, keepdim=True)
    safe = sigma > 1e-6 * torch.clamp(scale, min=1e-30)
    return torch.where(safe, g / torch.where(safe, sigma, torch.ones_like(sigma)),
                       torch.zeros_like(sigma))


class _Svdvals(torch.autograd.Function):
    """Singular values of (..., m, n), m <= n, from the eigh of A A^T;
    grad_A = U diag(g / sigma) U^T A, zero where sigma ~ 0."""

    @staticmethod
    def forward(ctx, a):
        eigvals, u = eigh_desc(a @ a.transpose(-1, -2))
        sigma = torch.sqrt(torch.clamp(eigvals, min=0.0))
        ctx.save_for_backward(a, sigma, u)
        return sigma

    @staticmethod
    def backward(ctx, g):
        a, sigma, u = ctx.saved_tensors
        coef = _safe_inverse(sigma, g)
        return (u * coef[..., None, :]) @ u.transpose(-1, -2) @ a


def svdvals(a):
    return _Svdvals.apply(a if a.shape[-2] <= a.shape[-1] else a.transpose(-1, -2))


def _polar_orthonormalize(v, iters=14):
    scale = torch.sqrt(torch.sum(v * v, dim=(-2, -1), keepdim=True))
    x = v / torch.clamp(scale, min=_TINY)
    for _ in range(iters):
        x = 1.5 * x - 0.5 * (x @ (x.transpose(-1, -2) @ x))
    return x


def start_block(d, k, device):
    """The subspace iteration's fixed start (numpy's generator, seed
    20240601)."""
    v0 = np.asarray(np.random.default_rng(20_240_601).standard_normal((d, k)), np.float32)
    return torch.from_numpy(v0).to(device)


def topk_basis_gram(g, k, g_iters=6, polar_iters=14):
    """Top-k basis (..., D, K) and singular values (..., K) behind a
    centered Gram: 6 subspace iterations, each orthonormalized by 14
    Newton-Schulz steps, then a K x K Rayleigh-Ritz eigh."""
    d = g.shape[-1]
    v = start_block(d, k, g.device).expand(*g.shape[:-2], d, k)
    gn = g / torch.clamp(torch.sqrt(torch.sum(g * g, dim=(-2, -1), keepdim=True)), min=_TINY)
    for _ in range(g_iters):
        v = _polar_orthonormalize(gn @ v, polar_iters)
    eigvals, u = eigh_desc(v.transpose(-1, -2) @ g @ v)
    return v @ u, torch.sqrt(torch.clamp(eigvals, min=0.0))


def principal_angle_distance(basis_s, basis_t, svals_t, rank):
    """Spectrally weighted squared Grassmann distance over the first
    `rank` directions of each side."""
    d = basis_s.shape[-1]
    idx = torch.arange(d, device=basis_s.device)
    mask = (idx < rank[..., None]).to(_F32)
    cross = basis_s.transpose(-1, -2) @ basis_t
    cross = cross * mask[..., :, None] * mask[..., None, :]
    theta = torch.arccos(torch.clamp(svdvals(cross), max=1.0 - _EPS))
    sw = svals_t * mask
    return torch.sum(sw * theta ** 2, dim=-1) / torch.clamp(sw.sum(-1), min=_TINY)


# the coupled quintic square-root schedule (each row minimizes
# max |1 - x (a + b x + c x^2)^2| over the greedy interval recursion from
# [1e-6, 1]); it needs a spectrum in [0, 1]: callers scale by ||W||_F
_NS_SQRT_SCHED = (
    (4.06041646, -5.30951808, 1.25316204),
    (3.51498112, -3.86445249, 1.06537910),
    (4.23379091, -6.27637272, 2.46647544),
    (3.87655076, -5.38737805, 1.97364126),
    (3.17457979, -3.56278794, 1.22570700),
    (2.03625467, -1.50239009, 0.46322166),
    (1.87507961, -1.24997583, 0.37489627),
)


def _sqrt_trace(w):
    """(tr(W^1/2), ~W^-1/2) by the scheduled coupled iteration."""
    scale = torch.clamp(torch.sqrt(torch.sum(w * w, dim=(-2, -1), keepdim=True)), min=_TINY)
    a = w / scale
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    y, z = a, eye.expand(a.shape)
    for ca, cb, cc in _NS_SQRT_SCHED:
        m = z @ y
        t = ca * eye + cb * m + cc * (m @ m)
        y = y @ t
        z = t @ z
    value = torch.sqrt(scale[..., 0, 0]) * torch.diagonal(y, dim1=-2, dim2=-1).sum(-1)
    return value, z / torch.sqrt(scale)


class _NuclearPairGram(torch.autograd.Function):
    """||S^T T||_nuc = tr((G_t G_s)^1/2) from the token Grams; backward
    dG_s = 1/2 G_t Z^T, dG_t = 1/2 Z^T G_s with Z ~ (G_t G_s)^-1/2."""

    @staticmethod
    def forward(ctx, g_s, g_t):
        value, z = _sqrt_trace(g_t @ g_s)
        ctx.save_for_backward(g_s, g_t, z)
        return value

    @staticmethod
    def backward(ctx, g):
        g_s, g_t, z = ctx.saved_tensors
        g = g[..., None, None]
        zt = z.transpose(-1, -2)
        return 0.5 * g * (g_t @ zt), 0.5 * g * (zt @ g_s)


def nuclear_norm_pair_gram(g_s, g_t):
    return _NuclearPairGram.apply(g_s, g_t)


def linear_interp_matrix(n_out, n_in):
    """W with W x == F.interpolate(x, n_out, mode='linear',
    align_corners=False) for a length-n_in signal."""
    w = np.zeros((n_out, n_in), dtype=np.float32)
    if n_in == 1:
        w[:, 0] = 1.0
        return w
    scale = n_in / n_out
    for i in range(n_out):
        src = min(max((i + 0.5) * scale - 0.5, 0.0), n_in - 1.0)
        i0 = int(np.floor(src))
        i1 = min(i0 + 1, n_in - 1)
        w[i, i0] += 1.0 - (src - i0)
        w[i, i1] += src - i0
    return w
