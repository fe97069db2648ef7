"""LayerNorm over the last axis for the calls that autograd does not need:
the hand-written kernel of `csrc/layernorm.cu` and its plain torch version.

`layer_norm_plain` is the composite every LayerNorm of the port runs under
autograd (`models/vit.py:_layer_norm`): x widened to fp32, torch's
LayerNorm with the fp32 weight and bias, the result rounded to x's dtype.
`layer_norm_cuda` reads each row once in its own dtype, keeps it in
registers, takes the mean and then the centred sum of squares in fp32 and
writes (x - mean) rsqrt(var + eps) w + b rounded once: 2 element-size bytes
a value moved, where the composite's cast, fp32 LayerNorm and cast move 10.
Its sums run in another order than torch's Welford kernel, so it is within a
unit in the last place of the composite, not its bits. A CUDA tensor
launches the kernel, one launch a call, or raises; a CPU tensor takes the
plain version. No backward: the kernel serves frozen teachers and eval
forwards, and `models/vit.py:_layer_norm`, its one caller, keeps every
call that autograd needs on the composite.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from basd_tpu_torch import kernels

_DTYPES = (torch.bfloat16, torch.float32)
# `basd_layernorm_route`'s codes
ROUTES = ("warp", "cta", "scalar")


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """LayerNorm over x's last axis in fp32, rounded once to x's dtype."""
    return F.layer_norm(x.float(), weight.shape, weight, bias, eps).to(x.dtype)


def layernorm_route(x: torch.Tensor, y: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor) -> str:
    """The route the library takes on these operands, as it reports it:
    "warp" or "cta" where D is a whole number of 16-byte vectors and every
    pointer is 16-byte aligned (a warp a row to 6 vectors a lane, else a
    block a row), else "scalar"."""
    code = kernels.library("layernorm").basd_layernorm_route(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), x.shape[-1],
        int(x.dtype == torch.bfloat16))
    return ROUTES[code]


def layer_norm_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """The kernel on bf16 or fp32 rows on the card, fp32 weight and bias of
    the rows' width on the same card; y in x's dtype. An input of another
    layout is made contiguous first."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"layernorm kernel takes bf16 or fp32, got {x.dtype}")
    d = x.shape[-1]
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (d,) or not t.is_contiguous():
            raise ValueError(f"layernorm kernel takes a contiguous fp32 {name} of shape "
                             f"({d},), got {t.dtype} {tuple(t.shape)}")
    if x.device.type != "cuda" or weight.device != x.device or bias.device != x.device:
        raise ValueError(f"layernorm kernel takes x, weight and bias on one CUDA device, got "
                         f"{x.device}, {weight.device}, {bias.device}")
    return _launch(x, weight, bias, eps)


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    """One launch on checked operands (none for an empty x)."""
    d = x.shape[-1]
    x = x.contiguous()
    y = torch.empty_like(x)
    rows = x.numel() // max(d, 1)
    if rows == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = kernels.library("layernorm").basd_layernorm_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, d, float(eps),
        int(x.dtype == torch.bfloat16), stream)
    kernels.check(status, f"layernorm ({rows}, {d}) {x.dtype}")
    kernels.LAUNCHES["layernorm"] += 1
    return y


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over x's last axis, fp32 statistics, the result in x's
    dtype: the kernel on a CUDA tensor, the plain version on the CPU."""
    if x.device.type == "cuda":
        return layer_norm_cuda(x, weight, bias, eps)
    return layer_norm_plain(x, weight, bias, eps)
