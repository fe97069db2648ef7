"""Attention-weighted Procrustes loss (`basd_tpu/losses/procrustes.py`).

Token importance w (B, N_t) is interpolated to the student token count and
normalized; both token sets are importance-centered and sqrt(w)-scaled;
the loss is tr(S^T S) + tr(T^T T) - 2 ||S^T T||_nuc, averaged over the
batch. On the Gram route every step is (N, N)-sized algebra on the raw
token Grams; the nuclear norm is the Newton-Schulz square root of
`spectral.ops.nuclear_norm_pair_gram`. All math in fp32; bf16 tokens are
upcast before their Gram products.
"""

from __future__ import annotations

import torch

from basd_tpu_torch.losses.interpolate import (
    align_token_count,
    align_vector,
    interp_matrix,
)
from basd_tpu_torch.spectral.ops import nuclear_norm_gram, nuclear_norm_pair_gram


def _gram(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return xf @ xf.transpose(-1, -2)


def _weighted_centered_gram(x: torch.Tensor, w: torch.Tensor):
    """(G_w, G_w + ridge) with G_w = D (X_c X_c^T) D for X (B, N, D),
    weights w (B, N) summing to 1, D = diag(sqrt(w)), from the raw Gram."""
    return _center_scale_gram(_gram(x), w)


def _center_scale_gram(g: torch.Tensor, w: torch.Tensor):
    """X_c X_c^T = G - a 1^T - 1 a^T + c 1 1^T with a = G w, c = w^T G w,
    then the sqrt(w) scaling, and a ridge 1e-6 w^T diag(G) on the copy that
    feeds the nuclear norm (the centered Gram of near-identical tokens is
    an indefinite roundoff matrix that the square-root schedule would
    amplify; the trace terms use the unridged Gram)."""
    a = (g @ w[..., None])[..., 0]
    c = torch.sum(w * a, dim=-1)
    g_c = g - a[:, :, None] - a[:, None, :] + c[:, None, None]
    ws = torch.sqrt(w)
    g_w = g_c * ws[:, :, None] * ws[:, None, :]
    lam = 1e-6 * torch.sum(w * torch.diagonal(g, dim1=-2, dim2=-1), dim=-1)
    eye = torch.eye(g.shape[-1], dtype=torch.float32, device=g.device)
    return g_w, g_w + lam[:, None, None] * eye


def _trace(g: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)


def _importance_weights(importance: torch.Tensor, n_s: int) -> torch.Tensor:
    w = align_vector(importance.float(), n_s)
    return w / w.sum(dim=-1, keepdim=True)


def procrustes_loss_mixed(
    student_tokens: torch.Tensor,  # (B, N_s, D_s)
    mixed_tokens: torch.Tensor,  # (B, N_t, D_t), NOT token-count aligned
    importance: torch.Tensor,  # (B, N_w)
    *,
    batch_total: int | None = None,
) -> torch.Tensor:
    """`procrustes_loss` on the unaligned mixed teacher tokens: the
    alignment happens in Gram space, G_aligned = A (M M^T) A^T with A the
    (N_s, N_t) interpolation matrix. Shapes outside the Gram route take
    the explicit alignment. `batch_total`: see `procrustes_loss`."""
    n_s = student_tokens.shape[1]
    n_t = mixed_tokens.shape[1]
    if not n_s <= min(student_tokens.shape[-1], mixed_tokens.shape[-1]):
        return procrustes_loss(
            student_tokens, align_token_count(mixed_tokens, n_s), importance,
            batch_total=batch_total,
        )
    w = _importance_weights(importance, n_s)
    g_s, g_s_r = _weighted_centered_gram(student_tokens, w)
    g_mix = _gram(mixed_tokens)
    if n_t != n_s:
        a = interp_matrix(n_s, n_t, g_mix.device)
        g_mix = a @ g_mix @ a.T
    g_t, g_t_r = _center_scale_gram(g_mix, w)
    nuc = nuclear_norm_pair_gram(g_s_r, g_t_r)
    return _batch_mean(_trace(g_s) + _trace(g_t) - 2.0 * nuc, batch_total)


def _batch_mean(per_sample: torch.Tensor, batch_total: int | None) -> torch.Tensor:
    if batch_total is None:
        return torch.mean(per_sample)
    return torch.sum(per_sample) / batch_total


def procrustes_loss(
    student_tokens: torch.Tensor,  # (B, N_s, D_s)
    teacher_tokens: torch.Tensor,  # (B, N_s, D_t), already aligned
    importance: torch.Tensor,  # (B, N_w)
    *,
    batch_total: int | None = None,
) -> torch.Tensor:
    """Procrustes loss on token-count-aligned tokens: the token-side Gram
    route when N_s <= min(D_s, D_t), else the feature-side route through
    the (D_s, D_t) cross-covariance. The batch mean divides by
    `batch_total` when the batch is a slice of one that large."""
    n_s = student_tokens.shape[1]
    w = _importance_weights(importance, n_s)
    if n_s <= min(student_tokens.shape[-1], teacher_tokens.shape[-1]):
        g_s, g_s_r = _weighted_centered_gram(student_tokens, w)
        g_t, g_t_r = _weighted_centered_gram(teacher_tokens, w)
        nuc = nuclear_norm_pair_gram(g_s_r, g_t_r)
        return _batch_mean(_trace(g_s) + _trace(g_t) - 2.0 * nuc, batch_total)

    s = student_tokens.float()
    t = teacher_tokens.float()
    w_sqrt = torch.sqrt(w)[..., None]
    s_w = w_sqrt * (s - (w[:, None, :] @ s))
    t_w = w_sqrt * (t - (w[:, None, :] @ t))
    tr_s = torch.sum(s_w * s_w, dim=(1, 2))
    tr_t = torch.sum(t_w * t_w, dim=(1, 2))
    nuc = nuclear_norm_gram(s_w.transpose(-1, -2) @ t_w)
    return _batch_mean(tr_s + tr_t - 2.0 * nuc, batch_total)
