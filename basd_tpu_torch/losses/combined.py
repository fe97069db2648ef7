"""Combined BASD objective: CE + mean Procrustes, UW-SO balanced
(`basd_tpu/losses/combined.py`).

Over a data-parallel mesh each rank holds a slice of the global batch:
the batch means divide by the global batch, so the ranks' parameter
gradients sum to the global gradient, and the UW-SO weights come from the
global CE and Procrustes values, summed over the data group (equal on
every rank). The loss a rank differentiates is then its slice's share of
the global loss; the logged values are the global ones.
"""

from __future__ import annotations

import torch

from basd_tpu_torch.losses.procrustes import procrustes_loss_mixed
from basd_tpu_torch.losses.selector import SelectorState, select_and_mix
from basd_tpu_torch.parallel.mesh import data_all_reduce
from basd_tpu_torch.utils.spans import span

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
    logits: torch.Tensor, soft_targets: torch.Tensor, label_smoothing: float = 0.0,
    *, batch_total: int | None = None,
) -> torch.Tensor:
    """torch `CrossEntropyLoss(label_smoothing=ls)` over probability
    targets: -sum_c [(1-ls) t_c + ls/C] log softmax(z)_c, batch mean (over
    `batch_total` rows when these are a slice of a larger batch)."""
    c = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    t = (1.0 - label_smoothing) * soft_targets + label_smoothing / c
    if batch_total is not None:
        return -torch.sum(t * logp) / batch_total
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
    mesh=None,
    spans=None,
) -> tuple[torch.Tensor, dict]:
    """Full BASD objective. Returns (scalar loss, aux diagnostics). Over a
    `mesh` the inputs are this rank's slice and the returned loss is the
    slice's share of the global loss (the one to differentiate); `aux`
    holds the global `loss`, `ce_loss` and `geo_loss`. With `spans` (the
    step's `utils.spans.SpanRecorder`) the selector is the `select` span and
    the rest, from the Procrustes terms on, the `procrustes` span."""
    total_b = None if mesh is None else student_logits.shape[0] * mesh.data
    ce = cross_entropy(student_logits, soft_targets, label_smoothing,
                       batch_total=total_b)
    with span(spans, "select"):
        mixed_tokens, mixed_importance, aux = select_and_mix(
            selector, student_tokens, teacher_tokens, teacher_importance,
            subspace_k=subspace_k, mesh=mesh,
        )
    with span(spans, "procrustes"):
        geo = torch.stack([
            procrustes_loss_mixed(
                student_tokens[i], mixed_tokens[i], mixed_importance[i],
                batch_total=total_b,
            )
            for i in range(student_tokens.shape[0])
        ]).mean()
        losses = torch.stack([ce, geo])
        if mesh is None:
            w = uw_so_weights(losses)
            total = torch.sum(w * losses)
            aux.update({"ce_loss": ce, "geo_loss": geo, "uw_so_weights": w})
            return total, aux
        global_losses = data_all_reduce(losses, mesh, "loss_sums")
        w = uw_so_weights(global_losses)
        aux.update({"ce_loss": global_losses[0], "geo_loss": global_losses[1],
                    "uw_so_weights": w, "loss": torch.sum(w * global_losses)})
        return torch.sum(w * losses), aux
