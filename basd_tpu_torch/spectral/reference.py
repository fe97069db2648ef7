"""Plain numpy/float64 definitions of the selector's spectral math; the
port's copy of `basd_tpu/spectral/reference.py`.

These are the oracles that the port's torch spectral ops and its selector
are held against: the Marchenko-Pastur threshold rank, the Grassmann
subspace of the centered tokens, the spectrally weighted principal angles,
the nuclear norm and the selector's mixing weights end to end. They use
straightforward dynamic-shape numpy (exact SVDs, dynamic top-k slicing)
where the torch ops use static shapes, K-capped bases and rank masks.

`selector_d2_np` is the one addition: the same math for every extraction
point at once, the teacher side computed once and its layers read one at
a time, for widths where `selector_weights_np` per point would repeat the
teacher's SVDs. This module imports numpy only.
"""

from __future__ import annotations

import numpy as np


def marchenko_pastur_rank_np(features: np.ndarray) -> int:
    """Number of covariance eigenvalues above the MP noise edge.

    q = D/M, sigma^2 = median eigenvalue, lambda_+ = sigma^2 (1+sqrt(q))^2.
    Uses the smaller-side Gram like the reference (M>=D -> D x D).
    """
    m, d = features.shape
    q = d / m
    if m >= d:
        cov = features.T @ features / m
    else:
        cov = features @ features.T / m
    eigvals = np.linalg.eigvalsh(cov)
    sigma2 = float(np.median(eigvals))
    lambda_plus = sigma2 * (1 + q**0.5) ** 2
    return int((eigvals > lambda_plus).sum())


def grassmann_subspace_np(z: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Top-k right-singular basis of the centered matrix + singular values."""
    z = z.astype(np.float64)
    z = z - z.mean(axis=0, keepdims=True)
    _, s, vt = np.linalg.svd(z, full_matrices=False)
    return vt[:k].T, s[:k]


def principal_angle_distance_np(
    u_s: np.ndarray, u_t: np.ndarray, spectral_weights: np.ndarray
) -> float:
    """Spectrally-weighted squared Grassmannian distance.

    sigma = svdvals(U_s^T U_t); theta = acos(clamp(sigma));
    d^2 = sum(sw * theta^2) / sum(sw) with sw/theta paired in descending
    order.
    """
    sigma = np.linalg.svd(u_s.T @ u_t, compute_uv=False)
    eps = np.finfo(sigma.dtype).eps
    theta = np.arccos(np.clip(sigma, None, 1.0 - eps))
    sw = spectral_weights
    return float((sw * theta**2).sum() / sw.sum())


def nuclear_norm_np(c: np.ndarray) -> float:
    return float(np.linalg.svd(c, compute_uv=False).sum())


def selector_weights_np(
    student_tokens: np.ndarray,  # (B, N_s, D_s)
    teacher_tokens: np.ndarray,  # (L, B, N_t, D_t)
    proj_s: np.ndarray,  # (D_s, D_s)
    proj_t: np.ndarray,  # (D_s, D_t)
    temperature: float,
    max_rank: int,
) -> np.ndarray:
    """End-to-end oracle for one extraction point's mixing weights (L,)."""
    L = teacher_tokens.shape[0]
    d_s = student_tokens.shape[-1]

    ranks, subspaces, swts = [], [], []
    for l in range(L):
        z_t = teacher_tokens[l].reshape(-1, teacher_tokens.shape[-1]) @ proj_t.T
        rank = min(marchenko_pastur_rank_np(z_t), max_rank)
        rank = max(rank, 1)
        basis, svals = grassmann_subspace_np(z_t, rank)
        ranks.append(rank)
        subspaces.append(basis)
        swts.append(svals)

    z_s = student_tokens.reshape(-1, d_s) @ proj_s.T
    z_s = z_s - z_s.mean(axis=0, keepdims=True)
    _, _, vt_s = np.linalg.svd(z_s.astype(np.float64), full_matrices=False)

    d2 = np.zeros(L)
    for l in range(L):
        u_s = vt_s[: ranks[l]].T
        d2[l] = principal_angle_distance_np(u_s, subspaces[l], swts[l])

    logits = -d2 / temperature
    logits = logits - logits.max()
    w = np.exp(logits)
    return w / w.sum()


def selector_d2_np(
    student_tokens: np.ndarray,  # (P, B, N_s, D_s)
    teacher_tokens,  # (L, B, N_t, D_t), or a sequence of L (B, N_t, D_t)
    proj_s: np.ndarray,  # (D_s, D_s)
    proj_t: np.ndarray,  # (D_s, D_t)
    max_rank: int,
) -> tuple[np.ndarray, np.ndarray]:
    """`selector_weights_np`'s squared distances for every extraction
    point: ((P, L) d^2, (L,) MP ranks). The teacher side (ranks, bases and
    spectral weights) is computed once for all P points, reading
    `teacher_tokens[l]` once per layer, so a sequence that loads a layer
    when indexed keeps one layer in memory at a time. The mixing weights
    of point p are softmax(-d2[p] / temperature), `selector_weights_np`'s
    on the same inputs."""
    ranks, subspaces, swts = [], [], []
    for l in range(len(teacher_tokens)):
        layer = np.asarray(teacher_tokens[l])
        z_t = layer.reshape(-1, layer.shape[-1]) @ proj_t.T
        rank = max(min(marchenko_pastur_rank_np(z_t), max_rank), 1)
        basis, svals = grassmann_subspace_np(z_t, rank)
        ranks.append(rank)
        subspaces.append(basis)
        swts.append(svals)

    d_s = student_tokens.shape[-1]
    d2 = np.zeros((student_tokens.shape[0], len(ranks)))
    for p in range(student_tokens.shape[0]):
        z_s = student_tokens[p].reshape(-1, d_s) @ proj_s.T
        z_s = z_s - z_s.mean(axis=0, keepdims=True)
        _, _, vt_s = np.linalg.svd(z_s.astype(np.float64), full_matrices=False)
        for l, rank in enumerate(ranks):
            d2[p, l] = principal_angle_distance_np(vt_s[:rank].T, subspaces[l], swts[l])
    return d2, np.asarray(ranks)
