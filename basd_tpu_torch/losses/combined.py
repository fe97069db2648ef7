"""Combined BASD objective: CE + mean Procrustes, UW-SO balanced
(`basd_tpu/losses/combined.py`)."""

from __future__ import annotations

import torch

from basd_tpu_torch.losses.procrustes import procrustes_loss_mixed
from basd_tpu_torch.losses.selector import SelectorState, select_and_mix

_EPS = torch.finfo(torch.float32).eps


def extraction_points(student_depth: int, num_points: int) -> tuple[int, ...]:
    """Evenly-spaced block indices incl. first and last; one point selects
    the last block."""
    if num_points == 1:
        return (student_depth - 1,)
    return tuple(
        round(i * (student_depth - 1) / (num_points - 1))
        for i in range(num_points)
    )


def cross_entropy(
    logits: torch.Tensor, soft_targets: torch.Tensor, label_smoothing: float = 0.0
) -> torch.Tensor:
    """torch `CrossEntropyLoss(label_smoothing=ls)` over probability
    targets: -sum_c [(1-ls) t_c + ls/C] log softmax(z)_c, batch mean."""
    c = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    t = (1.0 - label_smoothing) * soft_targets + label_smoothing / c
    return -torch.mean(torch.sum(t * logp, dim=-1))


def uw_so_weights(losses: torch.Tensor) -> torch.Tensor:
    """UW-SO: w_i = (1/L_i) / sum_j (1/L_j) on detached losses."""
    inv = 1.0 / torch.clamp(losses.detach(), min=_EPS)
    return inv / inv.sum()


def basd_loss(
    selector: SelectorState,
    student_logits: torch.Tensor,  # (B, C)
    soft_targets: torch.Tensor,  # (B, C)
    student_tokens: torch.Tensor,  # (P, B, N_s, D_s)
    teacher_tokens: torch.Tensor,  # (L, B, N_t, D_t)
    teacher_importance: torch.Tensor,  # (L, B, N_t)
    *,
    label_smoothing: float,
    subspace_k: int | None = None,
) -> tuple[torch.Tensor, dict]:
    """Full BASD objective. Returns (scalar loss, aux diagnostics)."""
    ce = cross_entropy(student_logits, soft_targets, label_smoothing)
    mixed_tokens, mixed_importance, aux = select_and_mix(
        selector, student_tokens, teacher_tokens, teacher_importance,
        subspace_k=subspace_k,
    )
    geo = torch.stack([
        procrustes_loss_mixed(
            student_tokens[i], mixed_tokens[i], mixed_importance[i]
        )
        for i in range(student_tokens.shape[0])
    ]).mean()
    losses = torch.stack([ce, geo])
    w = uw_so_weights(losses)
    total = torch.sum(w * losses)
    aux.update({"ce_loss": ce, "geo_loss": geo, "uw_so_weights": w})
    return total, aux
