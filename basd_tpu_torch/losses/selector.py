"""Spectrally-adaptive Grassmannian layer selector, batched
(`basd_tpu/losses/selector.py`).

One Gram reduction per side serves the MP ranks and the subspaces; bases
are K-capped by subspace iteration; all (P, L) masked principal-angle
spectra are one batch. Teacher statistics carry no gradient; the student
eigenbasis and the principal-angle spectrum do, so gradients reach the P
temperatures and the student tokens through the mixing weights.

Over a data-parallel mesh (`parallel/mesh.py`) the Grams, the token sums
and the counts are sums over the data group, so the MP ranks, subspaces
and angle spectra are those of the global batch and identical on every
rank (the JAX package's global-batch statistics). The teacher's sums carry
no gradient; the student's go through `data_sum`, whose backward sums the
ranks' upstream gradients.

Dtype contract: teacher tokens are consumed in their compute dtype, and
the projection's operands are rounded to it (proj_t too). bf16 tokens on a
CUDA device are projected by one bf16 x bf16 tensor-core product that
accumulates and writes fp32 (`aten::mm.dtype`): the product of two bf16
values is exact in fp32, so it sums the same exact products as an fp32
product of the upcast operands, in another order (the JAX package's
`preferred_element_type=jnp.float32`). Every other input (fp32 tokens, any
tensor on the CPU) is upcast and multiplied in fp32. The mixed teacher
tokens are stored back in the teacher dtype; everything else is fp32.

Memory: the tensor-core projection makes no fp32 copy of the teacher token
stack; the fp32 projection and the mix each multiply one, and the mix's
product keeps its copy for the backward. Where that copy would pass
F32_COPY_BYTES (DINOv2 ViT-g's 40 layers at batch 256: 16.1 GB), both take
the stack in slices whose copies stay under it, and the mix keeps no copy:
its backward upcasts the stored tokens again, a slice at a time
(`_MixSlices`). Smaller stacks (Table-1's ViT-L at 6.4 GB, Table-3's) take
one product as before.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.models.teacher import extract_intermediates
from basd_tpu_torch.parallel.mesh import data_sum
from basd_tpu_torch.spectral import (
    marchenko_pastur_rank,
    marchenko_pastur_rank_gram,
    masked_principal_angle_distance,
    topk_basis_gram,
    topk_basis_gram_nograd,
)

_DEFAULT_SUBSPACE_K = 96


class SelectorState(NamedTuple):
    log_temperatures: torch.Tensor  # (P,) learnable
    proj_s: torch.Tensor  # (D_s, D_s) frozen random orthogonal
    proj_t: torch.Tensor  # (D_s, D_t) frozen random semi-orthogonal


def _orthogonal(shape, generator: torch.Generator) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32)
    return torch.nn.init.orthogonal_(w, generator=generator)


def init_selector(
    seed: int, num_extraction_points: int, student_dim: int, teacher_dim: int,
    *, device=None,
) -> SelectorState:
    """Random orthogonal projections drawn on the CPU from `seed` (so every
    device gets the same ones) and temperatures with softplus(x) = 1. The
    log-temperatures require grad; the projections do not."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    proj_s = _orthogonal((student_dim, student_dim), g)
    proj_t = _orthogonal((student_dim, teacher_dim), g)
    log_temps = torch.full(
        (num_extraction_points,), math.log(math.e - 1.0), dtype=torch.float32
    )
    return SelectorState(
        log_temps.to(dev).requires_grad_(True), proj_s.to(dev), proj_t.to(dev)
    )


def temperatures(state: SelectorState) -> torch.Tensor:
    return F.softplus(state.log_temperatures)


# the largest fp32 copy of the teacher token stack the selector makes in
# one piece
F32_COPY_BYTES = 8 << 30


def _slices(n: int, row_bytes: int) -> list[slice]:
    """Slices of n rows whose fp32 copies (row_bytes each) stay within
    F32_COPY_BYTES; one slice where the whole fits."""
    pieces = -(-n * row_bytes // F32_COPY_BYTES)
    step = -(-n // max(pieces, 1))
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


# tensor-core projections made (`_project` on bf16 tokens on a CUDA device):
# one a `select_and_mix` or `calibrate_subspace_k` call there, none on the CPU
TENSOR_CORE_PROJECTIONS = 0


def tensor_core_projection(tokens: torch.Tensor) -> bool:
    """Whether `_project` multiplies `tokens` on the tensor cores: bf16
    tokens on a CUDA device."""
    return tokens.dtype == torch.bfloat16 and tokens.device.type == "cuda"


def _project(tokens: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """(L, M, D) tokens x (E, D) projection -> (L, M, E) fp32, from operands
    rounded to the tokens' dtype: on the tensor cores where
    `tensor_core_projection(tokens)`, else `_project_f32`."""
    global TENSOR_CORE_PROJECTIONS
    if not tensor_core_projection(tokens):
        return _project_f32(tokens, proj)
    l, m, d = tokens.shape
    out = torch.mm(tokens.reshape(l * m, d), proj.to(tokens.dtype).T, out_dtype=torch.float32)
    TENSOR_CORE_PROJECTIONS += 1
    return out.reshape(l, m, -1)


def _project_f32(tokens: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """`_project` as an fp32 product of the upcast operands; the tokens'
    fp32 copy made a slice of layers at a time where the whole would pass
    F32_COPY_BYTES."""
    p = proj.to(tokens.dtype).float().T
    l, m, d = tokens.shape
    parts = _slices(l, 4 * m * d)
    if len(parts) == 1:
        return tokens.float() @ p
    out = torch.empty((l, m, p.shape[1]), dtype=torch.float32, device=tokens.device)
    for part in parts:
        torch.matmul(tokens[part].float(), p, out=out[part])
    return out


class _MixSlices(torch.autograd.Function):
    """weights (P, L) x tokens (L, C) in fp32 from the tokens' stored dtype,
    the columns taken in slices whose fp32 copies stay under
    F32_COPY_BYTES; the weights' gradient is made from the stored tokens by
    the same slices, so no fp32 copy is kept for the backward (the tokens
    carry no gradient)."""

    @staticmethod
    def forward(ctx, weights, tokens):
        ctx.save_for_backward(weights, tokens)
        out = torch.empty((weights.shape[0], tokens.shape[1]), dtype=torch.float32,
                          device=tokens.device)
        for part in _slices(tokens.shape[1], 4 * tokens.shape[0]):
            out[:, part] = weights @ tokens[:, part].float()
        return out

    @staticmethod
    def backward(ctx, grad):
        weights, tokens = ctx.saved_tensors
        grad_w = torch.zeros_like(weights)
        for part in _slices(tokens.shape[1], 4 * tokens.shape[0]):
            grad_w += grad[:, part] @ tokens[:, part].float().T
        return grad_w, None


def _mix(weights: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """weights (P, L) x tokens (L, C) -> (P, C) fp32 from the tokens'
    stored dtype: one product where the tokens' fp32 copy fits
    F32_COPY_BYTES, else `_MixSlices`."""
    if tokens.numel() * 4 <= F32_COPY_BYTES:
        return weights @ tokens.float()
    return _MixSlices.apply(weights, tokens)


def calibrate_subspace_k(
    teacher,
    student_dim: int,
    calib_images: torch.Tensor,
    *,
    seed: int,
    num_extraction_points: int,
    margin: int = 16,
) -> int:
    """Staging-time `subspace_k`: the largest teacher-layer MP rank on a
    calibration batch, measured through the production projection (the
    selector of seed + 1), plus `margin`, rounded up to a multiple of 8 and
    capped at student_dim - 1."""
    sel = init_selector(
        seed + 1, num_extraction_points, student_dim, teacher.spec.embed_dim,
        device=calib_images.device,
    )
    tokens, _ = extract_intermediates(teacher, calib_images)
    l = tokens.shape[0]
    with torch.no_grad():
        z_t = _project(tokens.reshape(l, -1, tokens.shape[-1]), sel.proj_t)
        max_rank = int(marchenko_pastur_rank(z_t).max())
    k = min(student_dim - 1, 8 * -(-(max_rank + margin) // 8))
    print(f"subspace_k_calibrated max_rank={max_rank} k={k}")
    return k


def selector_k(subspace_k: int | None, student_dim: int, rows_s: int,
               rows_t: int) -> int:
    """The selector's subspace size K: `subspace_k` (96 when None) capped at
    D_s - 1 and at each side's token rows (batch x tokens)."""
    if subspace_k is None:
        subspace_k = min(_DEFAULT_SUBSPACE_K, student_dim - 1)
    return min(subspace_k, student_dim - 1, rows_s, rows_t)


def selector_eigh_shapes(num_points: int, teacher_layers: int, k: int) -> tuple:
    """The shapes of the selector's three eighs at subspace size `k`: the
    teacher's and the student's Rayleigh-Ritz (L | P, K, K) and the
    principal angles' Gram (P, L, K, K)."""
    return ((teacher_layers, k, k), (num_points, k, k), (num_points, teacher_layers, k, k))


def _global_moments(z: torch.Tensor, mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """(Gram z^T z, token sum) of (L, M, D) tokens, each summed over the
    data group in one all-reduce."""
    d = z.shape[-1]
    local = torch.cat([(z.transpose(-1, -2) @ z).flatten(1), z.sum(dim=-2)], dim=1)
    total = data_sum(local, mesh)
    return total[:, :d * d].reshape(-1, d, d), total[:, d * d:]


def select_and_mix(
    state: SelectorState,
    student_tokens: torch.Tensor,  # (P, B, N_s, D_s)
    teacher_tokens: torch.Tensor,  # (L, B, N_t, D_t)
    teacher_importance: torch.Tensor,  # (L, B, N_t)
    *,
    subspace_k: int | None = None,
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """Soft-select teacher layers per extraction point. Returns
    (mixed_tokens (P, B, N_t, D_t), mixed_importance (P, B, N_t), aux).
    Over a `mesh` the tokens are this rank's slice of the global batch
    (every rank's slice the same size) and the statistics global."""
    p, b, n_s, d_s = student_tokens.shape
    l, _, n_t, d_t = teacher_tokens.shape
    b_total = b if mesh is None else b * mesh.data
    k = selector_k(subspace_k, d_s, b_total * n_s, b_total * n_t)

    proj_t = state.proj_t.detach()
    proj_s = state.proj_s.detach()

    # ---- teacher statistics (no gradient) ----
    with torch.no_grad():
        z_t = _project(teacher_tokens.reshape(l, b * n_t, d_t), proj_t)
        m_t = b_total * n_t
        if mesh is None:
            g_t = z_t.transpose(-1, -2) @ z_t
            mu_t = z_t.mean(dim=-2)
        else:
            g_t, sum_t = _global_moments(z_t, mesh)
            mu_t = sum_t / m_t
        ranks = torch.clamp(marchenko_pastur_rank_gram(g_t, m_t), 1, k)
        g_ct = g_t - m_t * mu_t[:, :, None] * mu_t[:, None, :]
    basis_t, svals_t = topk_basis_gram_nograd(g_ct, k)  # (L, D_s, K), (L, K)

    # ---- student subspaces (differentiable) ----
    z_s = student_tokens.float().reshape(p, b * n_s, d_s) @ proj_s.T
    m_s = b_total * n_s
    if mesh is None:
        g_s = z_s.transpose(-1, -2) @ z_s
        mu_s = z_s.mean(dim=-2)
    else:
        g_s, sum_s = _global_moments(z_s, mesh)
        mu_s = sum_s / m_s
    g_cs = g_s - m_s * mu_s[:, :, None] * mu_s[:, None, :]
    basis_s, _ = topk_basis_gram(g_cs, k)  # (P, D_s, K)

    # ---- spectrally-weighted principal angles, all (P, L) pairs ----
    d2 = masked_principal_angle_distance(
        basis_s[:, None], basis_t[None], svals_t[None], ranks[None]
    )  # (P, L)

    tau = temperatures(state)
    weights = torch.softmax(-d2 / tau[:, None], dim=-1)  # (P, L)

    mixed_tokens = _mix(weights, teacher_tokens.reshape(l, -1)).reshape(
        p, b, n_t, d_t).to(teacher_tokens.dtype)
    mixed_importance = (
        weights @ teacher_importance.float().reshape(l, -1)
    ).reshape(p, b, n_t)

    aux = {
        "mixing_weights": weights,
        "grassmann_d2": d2,
        "mp_ranks": ranks,
        "temperatures": tau,
    }
    return mixed_tokens, mixed_importance, aux
