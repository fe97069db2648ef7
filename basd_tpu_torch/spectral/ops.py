"""Spectral primitives of the BASD selector and Procrustes loss, in torch.

Counterpart of `basd_tpu/spectral/ops.py`. Every SVD-class quantity comes from a symmetric eigendecomposition
of a small Gram matrix; data-dependent Marchenko-Pastur ranks become rank
masks over K-capped bases, so every shape is static.

Gradients follow the JAX package: the eigh backward is the transpose of
its gap-regularized JVP (finite on the degenerate tails of token Grams,
where the stock eigh backward divides by ~0 gaps), and the singular-value
and nuclear-norm functions carry the same custom backward rules.

All math is fp32. Where the JAX package asks for bf16x3 matmuls
(Precision.HIGH) the port multiplies in full fp32.
"""

from __future__ import annotations

import numpy as np
import torch

from basd_tpu_torch.device import device_constant
from basd_tpu_torch.spectral import mp_rank_kernel
from basd_tpu_torch.spectral.jacobi_kernel import kernel_jacobi_eigh
from basd_tpu_torch.spectral.mp_rank_kernel import kernel_mp_rank_gram, mp_covariance
from basd_tpu_torch.spectral.tridiag import mp_rank_sturm

_F32 = torch.float32
_TINY = torch.finfo(torch.float32).tiny
_EPS = torch.finfo(torch.float32).eps


def use_jacobi(shape) -> bool:
    """The Jacobi eigh gate of `basd_tpu/spectral/ops.py:_use_pallas_jacobi`,
    by shape alone: sweeps=6 converges to the fp32 floor at n <= 96, and
    small batches gain nothing from batch parallelism."""
    n = shape[-1]
    b = 1
    for d in shape[:-2]:
        b *= d
    return 16 <= n <= 96 and b >= 4


def use_mp_kernel(n: int) -> bool:
    """The MP-rank kernel's gate, by n alone: every n from 8 to the largest
    that a cluster of 8 CTAs holds in shared memory (`mp_rank_kernel.MAX_N`,
    659). Larger n (only the teacher's intrinsic dimension at staging) keeps
    the plain `mp_rank_sturm`, n < 8 `eigvalsh`."""
    return mp_rank_kernel.MIN_N <= n <= mp_rank_kernel.MAX_N


class _EighSafe(torch.autograd.Function):
    """eigh (ascending) with the transpose of the gap-regularized JVP as
    its backward: with X the tangent in the eigenbasis, the JVP is
    dw = diag(X), dv = v (F o X), F_ij = gap/(gap^2 + eps^2), F_ii = 0,
    gap_ij = w_j - w_i, eps = 1e-6 max|w|. Its transpose maps (gw, gv) to
    sym(v M v^T) with M = diag(gw) + F o (v^T gv)."""

    @staticmethod
    def forward(ctx, a):
        if use_jacobi(a.shape):
            w, v = kernel_jacobi_eigh(a, sweeps=6)  # descending
            w, v = w.flip(-1), v.flip(-1)
        else:
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


def _eigh_safe(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _EighSafe.apply(a)


def _eigh_desc(gram: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition, eigenvalues descending; eigvecs[...,
    :, i] is the i-th eigenvector."""
    gram = (gram + gram.transpose(-1, -2)) * 0.5
    w, v = _eigh_safe(gram)
    return w.flip(-1), v.flip(-1)


def centered_gram(z: torch.Tensor) -> torch.Tensor:
    """(..., M, D) -> (..., D, D) fp32 Gram of the column-centered matrix."""
    z = z.to(_F32)
    zc = z - z.mean(dim=-2, keepdim=True)
    return zc.transpose(-1, -2) @ zc


def grassmann_basis(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Full right-singular basis (..., D, D), descending, and singular
    values (..., D) of the column-centered (..., M, D) matrix (not / M);
    basis[..., :, i] is the i-th principal direction."""
    eigvals, basis = _eigh_desc(centered_gram(z))
    return basis, torch.sqrt(torch.clamp(eigvals, min=0.0))


def marchenko_pastur_rank(x: torch.Tensor) -> torch.Tensor:
    """MP threshold rank of (..., M, D) features (int32)."""
    m = x.shape[-2]
    x = x.to(_F32)
    return marchenko_pastur_rank_gram(x.transpose(-1, -2) @ x, m)


def marchenko_pastur_rank_gram(gram: torch.Tensor, m: int) -> torch.Tensor:
    """`marchenko_pastur_rank` from an UNCENTERED Gram X^T X (..., D, D)
    of M samples."""
    d = gram.shape[-1]
    if use_mp_kernel(d):
        return kernel_mp_rank_gram(gram, m)
    cov = mp_covariance(gram, m)
    if d >= 8:
        return mp_rank_sturm(cov, m)
    eigvals = torch.linalg.eigvalsh(cov)
    # numpy median: the mean of the two middle values
    sigma2 = 0.5 * (eigvals[..., (d - 1) // 2] + eigvals[..., d // 2])
    lambda_plus = sigma2 * (1.0 + (d / m) ** 0.5) ** 2
    return torch.sum(eigvals > lambda_plus[..., None], dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Singular values with a subgradient-safe backward
# ---------------------------------------------------------------------------


def _svdvals_fwd_math(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """sigma (desc) and left-singular basis U of (..., m, n), m <= n."""
    eigvals, u = _eigh_desc(a @ a.transpose(-1, -2))
    return torch.sqrt(torch.clamp(eigvals, min=0.0)), u


def _safe_inverse(sigma: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """g / sigma, with a zero coefficient where sigma <= 1e-6 max(sigma)."""
    scale = sigma.amax(dim=-1, keepdim=True)
    safe = sigma > 1e-6 * torch.clamp(scale, min=1e-30)
    return torch.where(
        safe, g / torch.where(safe, sigma, torch.ones_like(sigma)),
        torch.zeros_like(sigma),
    )


class _SvdvalsMLeN(torch.autograd.Function):
    """d sigma_j = u_j^T dA v_j with v_j = A^T u_j / sigma_j, so
    grad_A = U diag(g / sigma) U^T A, with a zero coefficient where
    sigma ~ 0 (a valid subgradient that keeps gradients finite)."""

    @staticmethod
    def forward(ctx, a):
        sigma, u = _svdvals_fwd_math(a)
        ctx.save_for_backward(a, sigma, u)
        return sigma

    @staticmethod
    def backward(ctx, g):
        a, sigma, u = ctx.saved_tensors
        coef = _safe_inverse(sigma, g)
        return ((u * coef[..., None, :]) @ u.transpose(-1, -2) @ a).to(a.dtype)


def svdvals_psd(a: torch.Tensor) -> torch.Tensor:
    """Singular values (descending) of (..., m, n) via eigh of the Gram of
    the smaller side."""
    if a.shape[-2] <= a.shape[-1]:
        return _SvdvalsMLeN.apply(a)
    return _SvdvalsMLeN.apply(a.transpose(-1, -2))


class _NuclearNorm(torch.autograd.Function):
    """Sum of singular values from the small-side Gram's eigh; the backward
    is U diag(1 / sigma) U^T A = U V^T (zero where sigma ~ 0)."""

    @staticmethod
    def forward(ctx, c):
        transposed = c.shape[-2] > c.shape[-1]
        a = c.transpose(-1, -2) if transposed else c
        sigma, u = _svdvals_fwd_math(a)
        ctx.save_for_backward(a, sigma, u)
        ctx.transposed = transposed
        return sigma.sum(dim=-1)

    @staticmethod
    def backward(ctx, g):
        a, sigma, u = ctx.saved_tensors
        coef = _safe_inverse(sigma, torch.ones_like(sigma))
        grad = (u * coef[..., None, :]) @ u.transpose(-1, -2) @ a
        grad = grad * g[..., None, None]
        return grad.transpose(-1, -2) if ctx.transposed else grad


def nuclear_norm(c: torch.Tensor) -> torch.Tensor:
    """Nuclear norm of (..., m, n) through an eigendecomposition: the
    high-accuracy oracle of the Procrustes loss's Newton-Schulz routes."""
    return _NuclearNorm.apply(c)


def _polar_newton_schulz(c: torch.Tensor, iters: int) -> torch.Tensor:
    """Polar factor U V^T of (..., m, n) by X <- 1.5 X - 0.5 X X^T X from
    C / ||C||_F (the Frobenius norm bounds the spectral norm)."""
    scale = torch.sqrt(torch.sum(c * c, dim=(-2, -1), keepdim=True))
    x = c / torch.clamp(scale, min=_TINY)
    for _ in range(iters):
        x = 1.5 * x - 0.5 * ((x @ x.transpose(-1, -2)) @ x)
    return x


class _NuclearNormNS(torch.autograd.Function):
    """||C||_nuc = tr(P^T C) with P the Newton-Schulz polar factor; the
    backward is P."""

    @staticmethod
    def forward(ctx, c, iters):
        cf = c.to(_F32)
        p = _polar_newton_schulz(cf, iters)
        ctx.save_for_backward(p)
        return torch.sum(p * cf, dim=(-2, -1))

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        return g[..., None, None] * p, None


def nuclear_norm_ns(c: torch.Tensor, iters: int = 24) -> torch.Tensor:
    """Nuclear norm via the Newton-Schulz polar decomposition: matmuls
    only, and d||C||_nuc / dC = P exactly."""
    return _NuclearNormNS.apply(c, iters)


# ---------------------------------------------------------------------------
# Gram-side Newton-Schulz square root
# ---------------------------------------------------------------------------

# Minimax-composite quintic schedule of the coupled square-root iteration
# (basd_tpu/spectral/ops.py:_NS_SQRT_SCHED, digit for digit): each (a, b, c)
# minimizes max |1 - x (a + b x + c x^2)^2| over the greedy interval
# recursion from [1e-6, 1]. Needs spectrum <= 1: callers scale by the
# Frobenius norm.
_NS_SQRT_SCHED = (
    (4.06041646, -5.30951808, 1.25316204),
    (3.51498112, -3.86445249, 1.06537910),
    (4.23379091, -6.27637272, 2.46647544),
    (3.87655076, -5.38737805, 1.97364126),
    (3.17457979, -3.56278794, 1.22570700),
    (2.03625467, -1.50239009, 0.46322166),
    (1.87507961, -1.24997583, 0.37489627),
)


def _ns_sqrt_pair(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Coupled scheduled-quintic iteration (Y, Z) -> (A^1/2, A^-1/2) for A
    with real nonnegative spectrum and spectral radius <= 1."""
    d = a.shape[-1]
    eye = torch.eye(d, dtype=a.dtype, device=a.device)
    y, z = a, eye.expand(a.shape)
    for ca, cb, cc in _NS_SQRT_SCHED:
        m = z @ y
        t = ca * eye + cb * m + cc * (m @ m)
        y = y @ t
        z = t @ z
    return y, z


def _frob(w: torch.Tensor) -> torch.Tensor:
    """Frobenius norm (..., 1, 1), clamped away from zero."""
    s = torch.sqrt(torch.sum(w * w, dim=(-2, -1), keepdim=True))
    return torch.clamp(s, min=_TINY)


def _sqrt_trace(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(tr(W^1/2), ~W^-1/2) for W with real nonnegative spectrum, by the
    scheduled iteration on W / ||W||_F."""
    scale = _frob(w)
    y, z = _ns_sqrt_pair(w / scale)
    value = torch.sqrt(scale[..., 0, 0]) * torch.diagonal(
        y, dim1=-2, dim2=-1).sum(-1)
    return value, z / torch.sqrt(scale)


class _NuclearNormGram(torch.autograd.Function):
    """||C||_nuc = tr((C C^T)^1/2) via the square-root iteration on the
    small-side Gram; the backward is the polar factor (C C^T)^-1/2 C, which
    the coupled iteration yields as Z C."""

    @staticmethod
    def forward(ctx, c):
        m, n = c.shape[-2], c.shape[-1]
        cf = (c if m <= n else c.transpose(-1, -2)).to(_F32)
        value, z = _sqrt_trace(cf @ cf.transpose(-1, -2))
        grad = z @ cf
        if m > n:
            grad = grad.transpose(-1, -2)
        ctx.save_for_backward(grad.to(c.dtype))
        return value

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g[..., None, None] * grad


def nuclear_norm_gram(c: torch.Tensor) -> torch.Tensor:
    return _NuclearNormGram.apply(c)


class _NuclearNormPairGram(torch.autograd.Function):
    """tr((G_t G_s)^1/2) = ||S^T T||_nuc from the token-side Grams
    G_s = S S^T, G_t = T T^T (..., N, N), with the backward
    dL/dG_s = 1/2 G_t Z^T, dL/dG_t = 1/2 Z^T G_s, Z ~ W^-1/2."""

    @staticmethod
    def forward(ctx, g_s, g_t):
        gs, gt = g_s.to(_F32), g_t.to(_F32)
        value, z = _sqrt_trace(gt @ gs)
        ctx.save_for_backward(gs, gt, z)
        ctx.dtypes = (g_s.dtype, g_t.dtype)
        return value

    @staticmethod
    def backward(ctx, g):
        gs, gt, z = ctx.saved_tensors
        g = g[..., None, None]
        zt = z.transpose(-1, -2)
        dgs = 0.5 * g * (gt @ zt)
        dgt = 0.5 * g * (zt @ gs)
        return dgs.to(ctx.dtypes[0]), dgt.to(ctx.dtypes[1])


def nuclear_norm_pair_gram(g_s: torch.Tensor, g_t: torch.Tensor) -> torch.Tensor:
    return _NuclearNormPairGram.apply(g_s, g_t)


class _NuclearNormPair(torch.autograd.Function):
    """||S^T T||_nuc on the token side: W = (T T^T)(S S^T), value tr(W^1/2),
    backward dL/dS = G_t Z^T S, dL/dT = G_s Z T with Z ~ W^-1/2."""

    @staticmethod
    def forward(ctx, s, t):
        sf, tf = s.to(_F32), t.to(_F32)
        g_t = tf @ tf.transpose(-1, -2)
        g_s = sf @ sf.transpose(-1, -2)
        value, z = _sqrt_trace(g_t @ g_s)
        ctx.save_for_backward(sf, tf, g_s, g_t, z)
        ctx.dtypes = (s.dtype, t.dtype)
        return value

    @staticmethod
    def backward(ctx, g):
        sf, tf, g_s, g_t, z = ctx.saved_tensors
        g = g[..., None, None]
        ds = g * (g_t @ z.transpose(-1, -2) @ sf)
        dt = g * (g_s @ z @ tf)
        return ds.to(ctx.dtypes[0]), dt.to(ctx.dtypes[1])


def nuclear_norm_pair(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """||S^T T||_nuc for S (..., N, D_s), T (..., N, D_t), computed on the
    (N, N) token side, where every Newton-Schulz matmul is smallest when N
    is the smallest axis."""
    return _NuclearNormPair.apply(s, t)


# ---------------------------------------------------------------------------
# Top-k eigenbasis via subspace iteration
# ---------------------------------------------------------------------------


def _polar_orthonormalize(v: torch.Tensor, iters: int = 14) -> torch.Tensor:
    """orth(V) = V (V^T V)^-1/2 via Newton-Schulz on the tall matrix:
    X <- 1.5 X - 0.5 X (X^T X)."""
    scale = torch.sqrt(torch.sum(v * v, dim=(-2, -1), keepdim=True))
    x = v / torch.clamp(scale, min=_TINY)
    for _ in range(iters):
        gram = x.transpose(-1, -2) @ x
        x = 1.5 * x - 0.5 * (x @ gram)
    return x


@device_constant
def _start_block(d: int, k: int, device: torch.device) -> torch.Tensor:
    """The subspace iteration's fixed (d, k) start on `device`."""
    v0 = np.asarray(
        np.random.default_rng(20_240_601).standard_normal((d, k)), np.float32
    )
    return torch.from_numpy(v0).to(device)


def topk_basis_gram(
    g: torch.Tensor, k: int, *, g_iters: int = 6, polar_iters: int = 14
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k basis (..., D, K) and singular values (..., K) of the
    centered data behind a CENTERED Gram (..., D, D): subspace iteration
    from a fixed numpy start, then one K x K Rayleigh-Ritz eigh.
    Differentiable end to end."""
    d = g.shape[-1]
    v = _start_block(d, k, g.device).expand(*g.shape[:-2], d, k)
    gnorm = torch.sqrt(torch.sum(g * g, dim=(-2, -1), keepdim=True))
    gn = g / torch.clamp(gnorm, min=_TINY)
    for _ in range(g_iters):
        v = _polar_orthonormalize(gn @ v, polar_iters)
    r = v.transpose(-1, -2) @ g @ v
    eigvals, u = _eigh_desc(r)
    basis = v @ u
    return basis, torch.sqrt(torch.clamp(eigvals, min=0.0))


def topk_basis(
    z: torch.Tensor, k: int, *, g_iters: int = 6, polar_iters: int = 14
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k right-singular basis (..., D, K) and singular values (..., K)
    of the column-centered (..., M, D) matrix: `topk_basis_gram` of its
    centered Gram."""
    return topk_basis_gram(centered_gram(z), k, g_iters=g_iters,
                           polar_iters=polar_iters)


def topk_basis_gram_nograd(
    g: torch.Tensor, k: int, *, g_iters: int = 6, polar_iters: int = 14
) -> tuple[torch.Tensor, torch.Tensor]:
    """`topk_basis_gram` for gradient-free callers (teacher statistics)."""
    with torch.no_grad():
        return topk_basis_gram(g, k, g_iters=g_iters, polar_iters=polar_iters)


# ---------------------------------------------------------------------------
# Masked principal angles
# ---------------------------------------------------------------------------


def masked_principal_angle_distance(
    basis_s: torch.Tensor,  # (..., Dp, K) student basis (grad flows)
    basis_t: torch.Tensor,  # (..., Dp, K) teacher basis
    svals_t: torch.Tensor,  # (..., K) teacher singular values, descending
    rank: torch.Tensor,  # (...,) int MP ranks
) -> torch.Tensor:
    """Spectrally-weighted squared Grassmannian distance with rank
    masking: zeros beyond rank k pair with zero spectral weights."""
    d = basis_s.shape[-1]
    idx = torch.arange(d, device=basis_s.device)
    mask = (idx < rank[..., None]).to(_F32)  # (..., K)
    cross = basis_s.to(_F32).transpose(-1, -2) @ basis_t.to(_F32)
    cross = cross * mask[..., :, None] * mask[..., None, :]
    sigma = svdvals_psd(cross)
    theta = torch.arccos(torch.clamp(sigma, max=1.0 - _EPS))
    sw = svals_t * mask
    sw_sum = torch.clamp(sw.sum(-1), min=_TINY)
    return torch.sum(sw * theta**2, dim=-1) / sw_sum
