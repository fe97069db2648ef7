"""Activations with the JAX package's precision contract: math in fp32,
result in the input dtype.

`gelu` is the exact (erf) GELU (`basd_tpu/ops/activations.py` computes the
same function through tanh, a TPU lowering device). A CUDA tensor launches
the hand-written kernels of `csrc/gelu.cu`, one launch a call forward and
one backward (`Gelu`, which saves x in its own dtype), or raises; a CPU
tensor takes the plain composite F.gelu(x.float()).to(x.dtype), whose
bits, and whose autograd's, the kernels give. `swiglu_gate` is the gate of
a SwiGLU MLP (DINOv2's ViT-g, timm's `SwiGLUPacked`): the packed fc1
output's halves a | b give silu(a) * b. A CUDA tensor launches the
hand-written kernel (`csrc/swiglu.cu`), one launch a call, or raises; a
CPU tensor takes the plain version, the same fp32 math as torch ops. The
gate kernel has no backward: the SwiGLU MLP runs in frozen teachers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from basd_tpu_torch import kernels

_DTYPES = (torch.bfloat16, torch.float32)


def gelu_plain(x: torch.Tensor) -> torch.Tensor:
    """The erf GELU in fp32, rounded once to x's dtype."""
    return F.gelu(x.float()).to(x.dtype)


def gelu_backward_plain(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """What `gelu_plain`'s autograd gives: dy and x widened to fp32, aten's
    gelu_backward, rounded once to x's dtype."""
    return torch.ops.aten.gelu_backward(dy.float(), x.float()).to(x.dtype)


def gelu_route(*tensors: torch.Tensor) -> str:
    """The kernels' route (`launch_fwd` / `launch_bwd` in the source):
    "vec" where every pointer is 16-byte aligned, else "scalar"."""
    return "vec" if all(t.data_ptr() % 16 == 0 for t in tensors) else "scalar"


def _check_gelu_operand(t: torch.Tensor, what: str) -> None:
    if t.dtype not in _DTYPES:
        raise ValueError(f"gelu kernel takes bf16 or fp32, got {what} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"gelu kernel takes a contiguous {what}")


def gelu_cuda(x: torch.Tensor) -> torch.Tensor:
    """The forward kernel on a contiguous bf16 or fp32 tensor on the card."""
    _check_gelu_operand(x, "x")
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = kernels.library("gelu").basd_gelu_fwd(
        x.data_ptr(), y.data_ptr(), n, int(x.dtype == torch.bfloat16), stream)
    kernels.check(status, f"gelu_fwd ({n} {x.dtype})")
    kernels.LAUNCHES["gelu_fwd"] += 1
    return y


def gelu_backward_cuda(dy: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The backward kernel: dx of dy and the saved x, one dtype, on the
    card. A gradient of another layout is made contiguous first."""
    _check_gelu_operand(x, "x")
    dy = dy.contiguous()
    if dy.dtype != x.dtype or dy.shape != x.shape:
        raise ValueError(f"gelu backward takes dy of x's dtype and shape, got {dy.dtype} "
                         f"{tuple(dy.shape)} for {x.dtype} {tuple(x.shape)}")
    dx = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return dx
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = kernels.library("gelu").basd_gelu_bwd(
        dy.data_ptr(), x.data_ptr(), dx.data_ptr(), n, int(x.dtype == torch.bfloat16), stream)
    kernels.check(status, f"gelu_bwd ({n} {x.dtype})")
    kernels.LAUNCHES["gelu_bwd"] += 1
    return dx


class Gelu(torch.autograd.Function):
    """The GELU with its own backward, which saves x in its own dtype (the
    composite saves an fp32 copy): the kernels on a CUDA tensor, the plain
    versions elsewhere."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return gelu_cuda(x) if x.device.type == "cuda" else gelu_plain(x)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        if x.device.type == "cuda":
            return gelu_backward_cuda(dy, x)
        return gelu_backward_plain(dy, x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The erf GELU in fp32, rounded once to x's dtype: on a CUDA tensor the
    kernels through `Gelu`; on the CPU the plain composite."""
    return Gelu.apply(x) if x.device.type == "cuda" else gelu_plain(x)


def swiglu_gate_plain(x: torch.Tensor) -> torch.Tensor:
    """(..., 2g) -> (..., g): silu(a) * b in fp32 over the halves a | b of
    the last axis, rounded once to x's dtype."""
    g = x.shape[-1] // 2
    a, b = x[..., :g].float(), x[..., g:2 * g].float()
    return (F.silu(a) * b).to(x.dtype)


def gate_route(x: torch.Tensor, out: torch.Tensor) -> str:
    """The kernel's route (`launch` in the source): "vec" where g is a
    multiple of a 16-byte vector and both pointers are 16-byte aligned,
    else "scalar"."""
    per = 16 // x.element_size()
    g = out.shape[-1]
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    return "vec" if g % per == 0 and aligned else "scalar"


def swiglu_gate_cuda(x: torch.Tensor) -> torch.Tensor:
    """The kernel on contiguous (..., 2g) bf16 or fp32 rows on the card."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"swiglu_gate kernel takes bf16 or fp32, got {x.dtype}")
    if not x.is_contiguous() or x.shape[-1] % 2:
        raise ValueError("swiglu_gate kernel takes contiguous rows of even width 2g")
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("swiglu_gate kernel has no backward: the SwiGLU MLP runs in "
                         "frozen teachers")
    g = x.shape[-1] // 2
    rows = x.numel() // max(2 * g, 1)
    out = torch.empty(x.shape[:-1] + (g,), dtype=x.dtype, device=x.device)
    if rows == 0 or g == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = kernels.library("swiglu").basd_swiglu_gate(
        x.data_ptr(), out.data_ptr(), rows, g, int(x.dtype == torch.bfloat16), stream)
    kernels.check(status, f"swiglu_gate ({rows} x {2 * g} {x.dtype})")
    kernels.LAUNCHES["swiglu_gate"] += 1
    return out


def swiglu_gate(x: torch.Tensor) -> torch.Tensor:
    """silu(x[..., :g]) * x[..., g:] of (..., 2g) rows, in fp32, rounded once
    to x's dtype: the kernel on a CUDA tensor, the plain version on the
    CPU."""
    if x.device.type == "cuda":
        return swiglu_gate_cuda(x)
    return swiglu_gate_plain(x)
