"""Wrapper of the Marchenko-Pastur rank kernel (`csrc/mp_rank.cu`).

The MP rank of batched uncentered Grams (..., n, n) of m samples: the
selector's teacher ranks (`losses/selector.py:select_and_mix`) and the K
calibration. `spectral.ops.marchenko_pastur_rank_gram` sends n inside the
kernel's gate (`spectral.ops.use_mp_kernel`: 8 <= n <= MAX_N) here, where
the tensor's device picks the implementation: a CUDA tensor launches the
kernel, one launch a call, or raises; a CPU tensor takes the plain
version, `spectral.tridiag.mp_rank_sturm` on the symmetrised covariance,
which runs the same Householder reflectors and Sturm bisection as torch
ops. n above the gate (the teacher's intrinsic dimension at widths 768 and
1024) stays on the plain version in `marchenko_pastur_rank_gram`.
"""

from __future__ import annotations

import ctypes

import torch

from basd_tpu_torch import kernels
from basd_tpu_torch.spectral.tridiag import mp_rank_sturm

_F32 = torch.float32

# the library's shared-memory layout (`smem_floats` in the source): a CTA
# holds its ceil(n / C) rows of the n x n matrix, x twice, p, the diagonal,
# b^2 and a scratch of 96 floats, within 227 KB
SMEM_LIMIT = 232_448
SCRATCH_FLOATS = 96
CLUSTERS = (1, 2, 4, 8)
MIN_N = 8


def smem_bytes(n: int, cluster: int) -> int:
    """Dynamic shared memory a CTA of a `cluster`-CTA group asks for at n."""
    rows = -(-n // cluster)
    return 4 * (rows * n + 5 * n + SCRATCH_FLOATS)


def cluster_size(n: int) -> int | None:
    """The CTAs a matrix takes: the least power of two whose slice of rows
    fits a CTA's shared memory (1 to n = 238, 2 to 335, 4 to 473, 8 to
    659), None above. At n = 384 four CTAs ran 9% faster than the three
    that fit, and 5 to 8 took 45-60% longer (PERF.md, kernel table)."""
    for c in CLUSTERS:
        if smem_bytes(n, c) <= SMEM_LIMIT:
            return c
    return None


MAX_N = max(n for n in range(MIN_N, 1024) if cluster_size(n) is not None)


def mp_covariance(gram: torch.Tensor, m: int) -> torch.Tensor:
    """The symmetrised covariance X^T X / m of an uncentered Gram."""
    cov = gram.to(_F32) / m
    return (cov + cov.transpose(-1, -2)) * 0.5


def _stream(a: torch.Tensor) -> int:
    return torch.cuda.current_stream(a.device).cuda_stream


def mp_rank_raw_cuda(gram: torch.Tensor, m: int):
    """(B, n, n) contiguous fp32 Grams on the card -> (ranks (B,) int32,
    diag (B, n), off2 (B, n - 1)), the tridiagonal's diagonal and squared
    off-diagonal, on `cluster_size(n)` CTAs a matrix."""
    if gram.dtype != _F32 or gram.dim() != 3 or not gram.is_contiguous():
        raise ValueError("mp_rank kernel takes contiguous fp32 (B, n, n)")
    b, n, n2 = gram.shape
    if n != n2 or not MIN_N <= n <= MAX_N:
        raise ValueError(f"mp_rank kernel takes square {MIN_N} <= n <= {MAX_N}, got {n}x{n2}")
    c = cluster_size(n)
    ranks = torch.empty((b,), dtype=torch.int32, device=gram.device)
    diag = torch.empty((b, n), dtype=_F32, device=gram.device)
    off2 = torch.empty((b, n - 1), dtype=_F32, device=gram.device)
    if b == 0:
        return ranks, diag, off2
    edge = (1.0 + (n / m) ** 0.5) ** 2
    status = kernels.library("mp_rank").basd_mp_rank(
        gram.data_ptr(), ranks.data_ptr(), diag.data_ptr(), off2.data_ptr(), b, n, c,
        ctypes.c_float(m), ctypes.c_float(edge), _stream(gram))
    kernels.check(status, f"mp_rank (n = {n}, {c} CTAs a matrix)")
    kernels.LAUNCHES["mp_rank"] += 1
    return ranks, diag, off2


def kernel_mp_rank_gram(gram: torch.Tensor, m: int) -> torch.Tensor:
    """MP threshold rank (int32, shape `gram.shape[:-2]`) of uncentered
    Grams X^T X (..., n, n) of m samples, 8 <= n <= MAX_N: sigma^2 the
    median eigenvalue of X^T X / m (the mean of the middle pair), lambda_+ =
    sigma^2 (1 + sqrt(n / m))^2, rank = #{eigenvalues > lambda_+}."""
    if gram.device.type != "cuda":
        return mp_rank_sturm(mp_covariance(gram, m), m)
    n = gram.shape[-1]
    ranks, _, _ = mp_rank_raw_cuda(gram.reshape(-1, n, n).to(_F32).contiguous(), m)
    return ranks.reshape(gram.shape[:-2])
