"""Whole-row multi-head attention: the kernels K1 (forward) and K2
(backward) in `csrc/attention.cu`, their plain torch versions, and one
`autograd.Function` that joins them.

Counterpart of `basd_tpu/ops/attention.py` (`fused_attention`,
`_fused_fwd_kernel`, `_fused_bwd_kernel`, `supports_fused`). The contract
is the Pallas kernel's: the native (B, N, D) layout with D = H * head_dim,
heads major, q pre-scaled; fp32 scores and rowmax; e = exp(s - m) rounded
to the compute dtype; denom = fp32 sum of the ROUNDED e (unlike
`xla_attention_ref`, which sums the unrounded e: the two agree in fp32 and
differ in bf16); o = (e v) / denom in fp32, stored in the compute dtype.
The forward saves (m, denom) as (B, N, H) fp32 and the backward recomputes
e from them, with dd = rowsum(dO * O) per head computed outside the kernel.

The tensor's device picks the implementation: CUDA tensors launch the
kernels (or raise), CPU tensors take the plain versions. On the card bf16
runs on the tensor cores and needs 16-byte aligned q, k, v, dO (base
pointer, batch and row strides); fp32 runs on the CUDA cores, since
tensor cores would take it as TF32.
"""

from __future__ import annotations

import torch

from basd_tpu_torch import kernels

MAX_FUSED_SEQ = 512
MAX_FUSED_HEAD_DIM = 128


def supports_fused(n: int, d: int, head_dim: int) -> bool:
    """Static shape gate of the kernels (`ops/attention.py:supports_fused`),
    without the TPU kernel's width cap of 2048: a Pallas block holds a whole
    (N, D) row slab in VMEM, while a CTA here holds one head's rows, so the
    width bounds nothing (DINOv3's ViT-7B runs D = 4096 at hd = 128)."""
    return (
        n <= MAX_FUSED_SEQ
        and head_dim <= MAX_FUSED_HEAD_DIM
        and head_dim % 16 == 0
        and d % head_dim == 0
    )


def _heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """(B, N, D) -> (B, H, N, hd) fp32."""
    b, n, d = x.shape
    return x.float().reshape(b, n, d // head_dim, head_dim).transpose(1, 2)


def _unheads(x: torch.Tensor, dtype) -> torch.Tensor:
    """(B, H, N, hd) -> (B, N, D) in `dtype`."""
    b, h, n, hd = x.shape
    return x.to(dtype).transpose(1, 2).reshape(b, n, h * hd)


def attention_forward_plain(q, k, v, head_dim: int):
    """K1's contract in torch ops: (o (B, N, D), m (B, N, H), denom (B, N, H))."""
    dt = q.dtype
    qh, kh, vh = (_heads(x, head_dim) for x in (q, k, v))
    s = qh @ kh.transpose(-1, -2)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m).to(dt).float()
    denom = e.sum(dim=-1, keepdim=True)
    o = (e @ vh) / denom
    stat = lambda x: x[..., 0].transpose(1, 2).contiguous()
    return _unheads(o, dt), stat(m), stat(denom)


def attention_backward_plain(q, k, v, do, m, denom, dd, head_dim: int):
    """K2's contract in torch ops: (dq, dk, dv), each (B, N, D)."""
    dt = q.dtype
    qh, kh, vh, doh = (_heads(x, head_dim) for x in (q, k, v, do))
    col = lambda x: x.transpose(1, 2)[..., None]  # (B, N, H) -> (B, H, N, 1)
    rdenom = 1.0 / col(denom)
    s = qh @ kh.transpose(-1, -2)
    e = torch.exp(s - col(m)).to(dt).float()
    do_scaled = (doh * rdenom).to(dt).float()
    dv = e.transpose(-1, -2) @ do_scaled
    dp = do_scaled @ vh.transpose(-1, -2)
    ds = (e * (dp - col(dd) * rdenom)).to(dt).float()
    dq = ds @ kh
    dk = ds.transpose(-1, -2) @ qh
    return _unheads(dq, dt), _unheads(dk, dt), _unheads(dv, dt)


def _check_cuda(tensors, names, head_dim):
    q = tensors[0]
    b, n, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"attention kernel takes fp32 or bf16, got {q.dtype}")
    if not supports_fused(n, d, head_dim):
        raise ValueError(
            f"attention kernel does not take N={n}, D={d}, head_dim={head_dim}"
        )
    if b > 65535 or d // head_dim > 65535:
        raise ValueError("attention kernel grid takes B, H <= 65535")
    for x, name in zip(tensors, names):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
        if x.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride in its last dim")
        # the bf16 kernels load 16-byte pieces by cp.async
        if q.dtype == torch.bfloat16 and (
                x.data_ptr() % 16 or x.stride(0) % 8 or x.stride(1) % 8):
            raise ValueError(
                f"{name} must be 16-byte aligned for the bf16 kernel: base "
                "pointer, and batch and row strides in multiples of 8")


def _check_stats(stats, q, head_dim):
    b, n, d = q.shape
    for x in stats:
        if (x.shape != (b, n, d // head_dim) or x.dtype != torch.float32
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError("attention stats must be contiguous fp32 (B, N, H)")


def _strides(x):
    return x.stride(0), x.stride(1)


def _attention_forward_cuda(q, k, v, head_dim: int):
    _check_cuda((q, k, v), ("q", "k", "v"), head_dim)
    b, n, d = q.shape
    h = d // head_dim
    o = torch.empty((b, n, d), dtype=q.dtype, device=q.device)
    m = torch.empty((b, n, h), dtype=torch.float32, device=q.device)
    denom = torch.empty((b, n, h), dtype=torch.float32, device=q.device)
    lib = kernels.library("attention")
    status = lib.basd_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), m.data_ptr(),
        denom.data_ptr(), b, n, h, head_dim, *_strides(q), *_strides(k),
        *_strides(v), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(status, "basd_attention_fwd")
    kernels.LAUNCHES["attention_fwd"] += 1
    return o, m, denom


def _attention_backward_cuda(q, k, v, do, m, denom, dd, head_dim: int):
    _check_cuda((q, k, v, do), ("q", "k", "v", "do"), head_dim)
    _check_stats((m, denom, dd), q, head_dim)
    b, n, d = q.shape
    dq, dk, dv = (torch.empty((b, n, d), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    lib = kernels.library("attention")
    status = lib.basd_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(),
        denom.data_ptr(), dd.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, n, d // head_dim, head_dim, *_strides(q),
        *_strides(k), *_strides(v), *_strides(do),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(status, "basd_attention_bwd")
    kernels.LAUNCHES["attention_bwd"] += 1
    return dq, dk, dv


def _on(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attention runs on cuda or cpu, not {x.device}")
    return x.device.type


def attention_forward(q, k, v, head_dim: int):
    """(o, m, denom): K1 on a CUDA tensor, its plain version on a CPU one."""
    if _on(q) == "cpu":
        return attention_forward_plain(q, k, v, head_dim)
    return _attention_forward_cuda(q, k, v, head_dim)


def attention_backward(q, k, v, do, m, denom, dd, head_dim: int):
    """(dq, dk, dv): K2 on a CUDA tensor, its plain version on a CPU one."""
    if _on(q) == "cpu":
        return attention_backward_plain(q, k, v, do, m, denom, dd, head_dim)
    return _attention_backward_cuda(q, k, v, do, m, denom, dd, head_dim)


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, head_dim):
        o, m, denom = attention_forward(q, k, v, head_dim)
        ctx.save_for_backward(q, k, v, o, m, denom)
        ctx.head_dim = head_dim
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, denom = ctx.saved_tensors
        hd = ctx.head_dim
        b, n, d = q.shape
        # softmax-VJP rowsum per head: rowsum(dP * P) == rowsum(dO * O), an
        # (N, D) pass here instead of an (N, N) pass in the kernel
        dd = (do.float() * o.float()).reshape(b, n, d // hd, hd).sum(-1)
        dq, dk, dv = attention_backward(
            q, k, v, do.to(q.dtype).contiguous(), m, denom, dd.contiguous(), hd
        )
        return dq, dk, dv, None


def fused_attention(q, k, v, head_dim: int) -> torch.Tensor:
    """Per-head softmax(q k^T) v from the native (B, N, D) layout, q
    pre-scaled by head_dim**-0.5; output (B, N, D) in q's dtype."""
    return _FusedAttention.apply(q, k, v, head_dim)


def _einsum_softmax(q, k, v, head_dim: int):
    """The einsum chain's unnormalized softmax: e = exp(s - max s) in fp32
    from logits in the compute dtype, its fp32 row sums (B, H, N, 1), and v
    as (B, H, N, hd)."""
    qh, kh, vh = (
        x.reshape(x.shape[0], x.shape[1], -1, head_dim).transpose(1, 2)
        for x in (q, k, v)
    )
    lf = (qh @ kh.transpose(-1, -2)).float()
    e = torch.exp(lf - lf.amax(dim=-1, keepdim=True))
    return e, e.sum(dim=-1, keepdim=True), vh


def xla_attention_ref(q, k, v, head_dim: int) -> torch.Tensor:
    """The ViT einsum-chain contract (`ops/attention.py:xla_attention_ref`):
    logits in the compute dtype, fp32 softmax, unrounded fp32 denom. The
    model's path for shapes outside `supports_fused`."""
    e, denom, vh = _einsum_softmax(q, k, v, head_dim)
    return _unheads((e.to(q.dtype).float() @ vh.float()) / denom, q.dtype)


def attention_mean_importance(q, k, v, head_dim: int):
    """The einsum chain (`xla_attention_ref`'s output, deferred
    normalization) and the normalized attention averaged over heads and
    queries, (B, N) fp32: the attention of a ViT without a CLS token
    (`basd_tpu/models/vit.py:190-208`). It needs the (B, H, N, N)
    attention, so it never takes the kernel."""
    e, denom, vh = _einsum_softmax(q, k, v, head_dim)
    out = _unheads((e.to(q.dtype).float() @ vh.float()) / denom, q.dtype)
    return out, (e / denom).mean(dim=(1, 2))
