"""Axial 2-D rotary positions (DINOv3's RoPE) on the q and k of a packed
qkv: the hand-written kernel of `csrc/rope.cu`, its plain torch version and
the table of angles they share.

DINOv3 (`transformers`' `DINOv3ViTRopePositionEmbedding` and
`apply_rotary_pos_emb`) gives each patch the centre of its cell on the grid,
normalised to [-1, 1] as (y, x), and each head hd / 4 frequencies
inv_freq = base^-(arange(0, 1, 4 / hd)); the angles 2 pi coord inv_freq,
laid out [y | x] (hd / 2 of them), rotate each head's halves x1 | x2 by
rotate_half: x1 cos - x2 sin | x2 cos + x1 sin (the published layout tiles
the angles twice over the head, so one half's table serves both). Only the
patch rows rotate; the prefix rows (CLS and register tokens) pass as they
are. No shift, jitter or rescale: a frozen teacher runs in eval mode.

`rope_qk` reads q and k from the packed qkv (B, N, 3D) and writes q scaled
by hd^-0.5 and rotated, and k rotated, each (B, N, D) in qkv's dtype: fp32
math, every op rounded as torch rounds it, the result rounded once. A CUDA
tensor launches the kernel, one launch a call, or raises; a CPU tensor takes
the plain version, whose bits the kernel gives. v stays a view of qkv. No
backward: rotary teachers are frozen.
"""

from __future__ import annotations

import math

import torch

from basd_tpu_torch import kernels

ROPE_BASE = 100.0  # DINOv3's rope_theta
_DTYPES = (torch.bfloat16, torch.float32)


def rope_table(grid_h: int, grid_w: int, head_dim: int) -> torch.Tensor:
    """(2, grid_h * grid_w, head_dim // 2) float32 on the CPU: the cos and
    sin of each patch's angles, patches row-major, y's frequencies then
    x's."""
    if head_dim % 4:
        raise ValueError(f"axial RoPE takes a head_dim divisible by 4, got {head_dim}")
    f32 = torch.float32
    coords_h = torch.arange(0.5, grid_h, dtype=f32) / grid_h
    coords_w = torch.arange(0.5, grid_w, dtype=f32) / grid_w
    coords = torch.stack(torch.meshgrid(coords_h, coords_w, indexing="ij"), dim=-1)
    coords = 2.0 * coords.flatten(0, 1) - 1.0  # (patches, 2) in [-1, 1]
    inv_freq = 1 / ROPE_BASE ** torch.arange(0, 1, 4 / head_dim, dtype=f32)  # (head_dim / 4,)
    angles = (2 * math.pi * coords[:, :, None] * inv_freq[None, None, :]).flatten(1, 2)
    return torch.stack([torch.cos(angles), torch.sin(angles)])


def _split(qkv: torch.Tensor, num_heads: int):
    b, n, three_d = qkv.shape
    if three_d % 3 or (three_d // 3) % num_heads or (three_d // 3 // num_heads) % 2:
        raise ValueError(f"rope_qk takes a packed qkv of 3 x heads x an even head_dim, "
                         f"got width {three_d} over {num_heads} heads")
    d = three_d // 3
    return b, n, d, d // num_heads


def rope_qk_plain(qkv: torch.Tensor, table: torch.Tensor, num_heads: int, prefix: int,
                  scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(q rotated and scaled, k rotated), each (B, N, D) in qkv's dtype, from
    the packed (B, N, 3D): fp32 torch ops on the stored values, the patch
    rows (from `prefix` on) rotated by `table`'s (cos, sin), the result
    rounded once."""
    b, n, d, hd = _split(qkv, num_heads)
    h2 = hd // 2
    cos, sin = table[0][:, None, :], table[1][:, None, :]  # (patches, 1, h2)

    def rot(x):  # (B, patches, H, hd) fp32
        x1, x2 = x[..., :h2], x[..., h2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    q = qkv[..., :d].float().reshape(b, n, num_heads, hd)
    k = qkv[..., d:2 * d].float().reshape(b, n, num_heads, hd)
    q = torch.cat([q[:, :prefix], rot(q[:, prefix:])], dim=1) * scale
    k = torch.cat([k[:, :prefix], rot(k[:, prefix:])], dim=1)
    return q.reshape(b, n, d).to(qkv.dtype), k.reshape(b, n, d).to(qkv.dtype)


def rope_route(qkv: torch.Tensor, num_heads: int, *outs: torch.Tensor) -> str:
    """The kernel's route (`launch` in the source): "vec" where each head's
    half is a whole number of 16-byte vectors and every pointer and row is
    16-byte aligned, else "scalar"."""
    _, _, d, hd = _split(qkv, num_heads)
    per = 16 // qkv.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in (qkv, *outs))
    return "vec" if (hd // 2) % per == 0 and (d * qkv.element_size()) % 16 == 0 and aligned \
        else "scalar"


def rope_qk_cuda(qkv: torch.Tensor, table: torch.Tensor, num_heads: int, prefix: int,
                 scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel on a contiguous packed qkv on the card; `table` fp32 on
    the same card, (2, N - prefix, head_dim // 2)."""
    b, n, d, hd = _split(qkv, num_heads)
    if qkv.dtype not in _DTYPES:
        raise ValueError(f"rope_qk kernel takes bf16 or fp32, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("rope_qk kernel takes a contiguous packed qkv")
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise ValueError("rope_qk kernel has no backward: rotary teachers are frozen")
    if not 0 <= prefix < n:
        raise ValueError(f"rope_qk takes 0 <= prefix < N, got prefix {prefix} of N {n}")
    if (table.dtype != torch.float32 or not table.is_contiguous()
            or tuple(table.shape) != (2, n - prefix, hd // 2) or table.device != qkv.device):
        raise ValueError(f"rope_qk takes a contiguous fp32 table (2, {n - prefix}, {hd // 2}) "
                         f"on {qkv.device}, got {table.dtype} {tuple(table.shape)} on "
                         f"{table.device}")
    q = torch.empty((b, n, d), dtype=qkv.dtype, device=qkv.device)
    k = torch.empty_like(q)
    if b == 0:
        return q, k
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    status = kernels.library("rope").basd_rope_qk(
        qkv.data_ptr(), table.data_ptr(), q.data_ptr(), k.data_ptr(), b * n, n, prefix,
        num_heads, hd, float(scale), int(qkv.dtype == torch.bfloat16), stream)
    kernels.check(status, f"rope_qk ({b}, {n}, {3 * d}) {qkv.dtype}")
    kernels.LAUNCHES["rope_qk"] += 1
    return q, k


def rope_qk(qkv: torch.Tensor, table: torch.Tensor, num_heads: int, prefix: int,
            scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(q scaled by `scale` and rotated, k rotated) on the patch rows, the
    prefix rows scaled and passed: the kernel on a CUDA tensor, the plain
    version on the CPU."""
    if qkv.device.type == "cuda":
        return rope_qk_cuda(qkv, table, num_heads, prefix, scale)
    return rope_qk_plain(qkv, table, num_heads, prefix, scale)
