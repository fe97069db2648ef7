"""Eigenvalues-free Marchenko-Pastur rank: Householder tridiagonalization
plus Sturm-sequence bisection.

Counterpart of `basd_tpu/spectral/tridiag.py`. The MP rank needs only the
median eigenvalue and one count above a threshold, never the spectrum:
one Householder reduction to tridiagonal form, then O(n)-per-shift Sturm
counts locate the median pair by multi-shift bracketing and count the
eigenvalues above lambda_+. Everything is batched over the leading axes.

The bracket runs BRACKET_ROUNDS rounds where the JAX package's runs 3.
Each round narrows it by 129 from the whole Gershgorin interval, so 3
rounds leave it 5e-7 of the spectrum's span wide: within 1e-4 of the
median only where the top eigenvalue lies within about 200 times it. An
uncentered Gram of tokens that share a strong mean puts its top 1e3 times
the median or more. On such Grams (n 384, top 6e3 and 6.6e5 times the
median) 3 rounds left sigma^2 1e-3 and 0.15 of itself from the float64
oracle's and moved lambda_+ across eigenvalues, while the fp32 reduction
and counts stay within 1e-6 and 3.5e-5 of it. Seven rounds (129^7 = 2^49) reach
sigma^2's fp32 spacing for any top up to 2^26 times the median.
"""

from __future__ import annotations

import torch

from basd_tpu_torch.device import device_constant

_F32 = torch.float32
# rounds of the median's multi-shift bracket (module docstring)
BRACKET_ROUNDS = 7


def householder_tridiag(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched reduction of symmetric (..., n, n) to tridiagonal form.

    Returns (diag (..., n), offdiag (..., n-1)) with the eigenvalues of
    `a` (orthogonal similarity)."""
    batch_shape = a.shape[:-2]
    n = a.shape[-1]
    a = a.reshape(-1, n, n).to(_F32)
    a = (a + a.transpose(-1, -2)) * 0.5
    idx = torch.arange(n, device=a.device)
    for k in range(n - 2):
        col = a[:, :, k]  # (B, n)
        x = col * (idx > k).to(_F32)
        xnorm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
        head = col[:, k + 1 : k + 2]  # x_{k+1}
        sgn = torch.where(head >= 0.0, 1.0, -1.0)
        alpha = -sgn * xnorm
        v = x - torch.where(idx == k + 1, alpha, torch.zeros_like(alpha))
        vtv = torch.sum(v * v, dim=-1, keepdim=True)
        tau = torch.where(
            vtv > 0.0, 2.0 / torch.where(vtv > 0.0, vtv, torch.ones_like(vtv)),
            torch.zeros_like(vtv),
        )
        # symmetric rank-2 update: A <- A - v u^T - u v^T
        p = tau * torch.einsum("bij,bj->bi", a, v)
        k2 = 0.5 * tau * torch.sum(p * v, dim=-1, keepdim=True)
        u = p - k2 * v
        a = a - v[:, :, None] * u[:, None, :] - u[:, :, None] * v[:, None, :]
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    off = torch.diagonal(a[:, 1:, :-1], dim1=-2, dim2=-1)  # a[i+1, i]
    return diag.reshape(*batch_shape, n), off.reshape(*batch_shape, n - 1)


def sturm_count(
    diag: torch.Tensor,  # (..., n)
    off2: torch.Tensor,  # (..., n-1) SQUARED off-diagonals
    shifts: torch.Tensor,  # (..., S)
) -> torch.Tensor:
    """#eigenvalues < shift for each shift, via the LDL^T recurrence
    d_i = (a_i - x) - b_{i-1}^2 / d_{i-1}; count = #(d_i < 0), with |d|
    clamped away from zero at sqrt(fp32 tiny) scale."""
    n = diag.shape[-1]
    scale = torch.clamp(diag.abs().amax(dim=-1, keepdim=True), min=1e-30)
    floor = (1.1754944e-38 ** 0.5) * scale
    d = torch.ones_like(shifts)
    count = torch.zeros(shifts.shape, dtype=torch.int32, device=shifts.device)
    zero = torch.zeros_like(off2[..., :1])
    b2 = torch.cat([zero, off2], dim=-1)
    for i in range(n):
        d = (diag[..., i : i + 1] - shifts) - b2[..., i : i + 1] / d
        safe = torch.maximum(d.abs(), floor)
        d = torch.where(d >= 0.0, safe, -safe)
        count = count + (d < 0.0).to(torch.int32)
    return count


@device_constant
def _order_constant(ks: tuple[int, int], device: torch.device) -> torch.Tensor:
    """The order statistics `ks` as int32 on `device`."""
    return torch.tensor(ks, dtype=torch.int32, device=device)


def _kth_pair_bracket(
    diag: torch.Tensor,  # (B, n)
    off2: torch.Tensor,  # (B, n-1)
    ks: tuple[int, int],
    *,
    num_shifts: int = 128,
    rounds: int = BRACKET_ROUNDS,
) -> torch.Tensor:
    """(B, 2) approximations of the ks[0]-th and ks[1]-th smallest
    eigenvalues (0-indexed), each to (hi-lo)/num_shifts^rounds."""
    b = diag.shape[0]
    r = torch.sqrt(off2).abs()
    zero = torch.zeros_like(r[:, :1])
    radius = torch.cat([r, zero], dim=-1) + torch.cat([zero, r], dim=-1)
    lo = torch.amin(diag - radius, dim=-1)
    hi = torch.amax(diag + radius, dim=-1)
    span = hi - lo
    lo = lo - 0.01 * span - 1e-30
    hi = hi + 0.01 * span + 1e-30

    k_arr = _order_constant(tuple(ks), diag.device)
    lo = lo[:, None].expand(b, 2)
    hi = hi[:, None].expand(b, 2)
    grid = (torch.arange(num_shifts, dtype=_F32, device=diag.device) + 1.0) / (
        num_shifts + 1.0
    )
    for _ in range(rounds):
        shifts = lo[..., None] + (hi - lo)[..., None] * grid  # (B, 2, S)
        counts = sturm_count(diag[:, None, :], off2[:, None, :], shifts)
        # lambda_k in (x_j, x_{j+1}] where count(x_j) <= k < count(x_{j+1})
        le = counts <= k_arr[None, :, None]
        lo = torch.amax(torch.where(le, shifts, lo[..., None]), dim=-1)
        hi = torch.amin(torch.where(~le, shifts, hi[..., None]), dim=-1)
    return 0.5 * (lo + hi)


def mp_rank_sturm(
    cov: torch.Tensor, m: int, *, num_shifts: int = 128, rounds: int = BRACKET_ROUNDS
) -> torch.Tensor:
    """MP threshold rank of batched covariances (..., d, d) of m samples:
    sigma^2 = median eigenvalue (numpy average-of-middle-pair), lambda_+ =
    sigma^2 (1 + sqrt(d/m))^2, rank = #{eig > lambda_+}."""
    batch_shape = cov.shape[:-2]
    d = cov.shape[-1]
    diag, off = householder_tridiag(cov.reshape(-1, d, d))
    off2 = off * off
    ks = ((d - 1) // 2, d // 2)
    pair = _kth_pair_bracket(diag, off2, ks, num_shifts=num_shifts, rounds=rounds)
    sigma2 = 0.5 * (pair[:, 0] + pair[:, 1])
    q = d / m
    lambda_plus = sigma2 * (1.0 + q**0.5) ** 2
    below = sturm_count(diag, off2, lambda_plus[:, None])[:, 0]
    return (d - below).to(torch.int32).reshape(batch_shape)
