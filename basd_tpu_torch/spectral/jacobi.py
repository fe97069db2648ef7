"""Batch-parallel cyclic Jacobi symmetric eigensolver in plain torch: the
plain versions of the Jacobi eigh and eigenvalues kernels
(`spectral/jacobi_kernel.py`).

Counterpart of `basd_tpu/spectral/jacobi.py` (and of the eigenvalues-only
`pallas_jacobi_eigvals`). One parallel-order step
rotates the n/2 disjoint pairs (i, i + h), h = n/2, of every matrix in the
batch at once; the pairs are the contiguous top and bottom halves, so the
rotations are elementwise combinations of two halves. Between steps the
half-shift round-robin permutation

    new = [x_0, x_h, x_1..x_{h-2}, x_{h+1}..x_{n-1}, x_{h-1}]

makes every pair meet exactly once per sweep of n - 1 steps.
"""

from __future__ import annotations

import torch


def rotate_positions(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Half-shift round-robin permutation along `dim` (see module doc)."""
    n = x.shape[dim]
    h = n // 2
    sl = lambda lo, hi: x.narrow(dim, lo, hi - lo)
    return torch.cat(
        [sl(0, 1), sl(h, h + 1), sl(1, h - 1), sl(h + 1, n), sl(h - 1, h)],
        dim=dim,
    )


def diag_of(a: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(a, dim1=-2, dim2=-1)


def pair_rotations(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Jacobi (c, s), each (B, h), for the half-shift pairs (i, i + h)."""
    n = a.shape[-1]
    h = n // 2
    d = diag_of(a)
    app = d[:, :h]
    aqq = d[:, h:]
    apq = torch.diagonal(a[:, :h, h:], dim1=-2, dim2=-1)  # a[i, i + h]

    safe = apq.abs() > 1e-30
    tau = (aqq - app) / torch.where(safe, 2.0 * apq, torch.ones_like(apq))
    sgn = torch.where(tau >= 0.0, 1.0, -1.0)
    t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    c = torch.where(safe, c, torch.ones_like(c))
    s = torch.where(safe, s, torch.zeros_like(s))
    return c, s


def apply_rows(a: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """row_i' = c row_i - s row_{i+h}; row_{i+h}' = s row_i + c row_{i+h}."""
    h = a.shape[1] // 2
    top, bot = a[:, :h], a[:, h:]
    cc, ss = c[:, :, None], s[:, :, None]
    return torch.cat([cc * top - ss * bot, ss * top + cc * bot], dim=1)


def apply_cols(a: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    h = a.shape[2] // 2
    left, right = a[:, :, :h], a[:, :, h:]
    cc, ss = c[:, None, :], s[:, None, :]
    return torch.cat([cc * left - ss * right, ss * left + cc * right], dim=2)


def jacobi_step(
    a: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    c, s = pair_rotations(a)
    a = apply_cols(apply_rows(a, c, s), c, s)
    v = apply_cols(v, c, s)
    a = rotate_positions(rotate_positions(a, 1), 2)
    v = rotate_positions(v, 2)
    return a, v


def _sort_desc(
    w: torch.Tensor, v: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    order = torch.argsort(-w, dim=-1, stable=True)
    w = torch.gather(w, -1, order)
    v = torch.gather(v, -1, order[:, None, :].expand(v.shape))
    return w, v


def _strip_pad(
    w: torch.Tensor, v: torch.Tensor, n0: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop the decoupled padding direction (eigenvalue 0, vector e_n)."""
    n = w.shape[-1]
    pad_idx = torch.argmax(v[:, n0, :].abs(), dim=-1)
    keep = torch.arange(n, device=w.device)[None, :] != pad_idx[:, None]
    order0 = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)[:, :n0]
    w = torch.gather(w, -1, order0)
    v = torch.gather(v[:, :n0, :], -1, order0[:, None, :].expand(-1, n0, -1))
    return w, v


def symmetrize_pad(a: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(..., n0, n0) -> ((B, n, n) fp32 symmetric, padded to even n; n0)."""
    n0 = a.shape[-1]
    a = a.reshape(-1, n0, n0).to(torch.float32)
    a = (a + a.transpose(-1, -2)) * 0.5
    if n0 % 2:
        a = torch.nn.functional.pad(a, (0, 1, 0, 1))
    return a, n0


def finish(
    w: torch.Tensor, v: torch.Tensor, n0: int, batch_shape, sort: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Strip an odd-n pad, sort descending, restore the batch shape."""
    if w.shape[-1] != n0:
        w, v = _strip_pad(w, v, n0)
    if sort:
        w, v = _sort_desc(w, v)
    return w.reshape(*batch_shape, n0), v.reshape(*batch_shape, n0, n0)


def jacobi_eigh(
    a: torch.Tensor, *, sweeps: int = 10, sort: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition of (..., n, n), batch-parallel.

    Returns (eigvals, eigvecs) with eigvecs[..., :, i] the i-th
    eigenvector; descending eigenvalue order when sort=True. Odd n is
    padded internally (the pad direction decouples exactly)."""
    batch_shape = a.shape[:-2]
    a, n0 = symmetrize_pad(a)
    b, n = a.shape[0], a.shape[-1]
    v = torch.eye(n, dtype=torch.float32, device=a.device).expand(b, n, n)
    for _ in range((n - 1) * sweeps):
        a, v = jacobi_step(a, v)
    return finish(diag_of(a), v, n0, batch_shape, sort)


def finish_eigvals(w: torch.Tensor, n0: int, batch_shape) -> torch.Tensor:
    """Sort ascending; an odd n's pad contributes one zero eigenvalue,
    dropped as the entry of smallest |w|; restore the batch shape."""
    w = torch.sort(w, dim=-1).values
    n = w.shape[-1]
    if n != n0:
        drop = torch.argmin(w.abs(), dim=-1)
        keep = torch.arange(n, device=w.device)[None, :] != drop[:, None]
        order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)[:, :n0]
        w = torch.sort(torch.gather(w, -1, order), dim=-1).values
    return w.reshape(*batch_shape, n0)


def jacobi_eigvals(a: torch.Tensor, *, sweeps: int = 9) -> torch.Tensor:
    """Eigenvalues only (ascending, eigvalsh-compatible) of (..., n, n):
    the plain version of the Jacobi eigenvalues kernel, K3's rotations
    without the eigenvector accumulator (counterpart of
    `pallas_jacobi_eigvals`)."""
    batch_shape = a.shape[:-2]
    a, n0 = symmetrize_pad(a)
    for _ in range((a.shape[-1] - 1) * sweeps):
        c, s = pair_rotations(a)
        a = apply_cols(apply_rows(a, c, s), c, s)
        a = rotate_positions(rotate_positions(a, 1), 2)
    return finish_eigvals(diag_of(a), n0, batch_shape)
