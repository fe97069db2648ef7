"""The TrivialAugment geometric warp: kernel K4 (`csrc/warp.cu`), its plain
torch version and the wrapper.

Counterpart of `basd_tpu/ops/warp_kernel.py` (`fused_geometric_warp`,
`_warp_kernel`, `pass_bounds`). On square fp32 (B, n, n, C) images, per
sample and in order: an optional hflip, a lossless quarter-turn by k, and
three 1-D bilinear shear passes with zero fill that sample
out[s] = in[s + delta]:
  pass 1 along W, delta = alpha * (y - cy) + tx for row y;
  pass 2 along H, delta = beta * (x - cy) + ty for column x;
  pass 3 along W, delta = gamma * (y - cy);
with cy = (n - 1) / 2. Identity parameters give the input bit for bit.

The tensor's device picks the implementation: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes `geometric_warp_plain`.
"""

from __future__ import annotations

import math

import torch

from basd_tpu_torch import kernels

_PAETH_MAX = math.tan(math.pi / 8.0)  # residual rotation |psi_r| <= 45 deg
_SHEAR_MAX = 0.99
_TRANS_MAX = 32.0
# the kernel holds at least one n x (n + 1) fp32 plane in a CTA's shared
# memory (227 KB): n <= 240 covers the Table-1 224 px images
MAX_N = 240
_MAX_SHARED_BYTES = 232448
_MAX_CLUSTER = 8  # CTAs in a portable thread-block cluster


def plane_ld(n: int) -> int:
    """The row stride of the kernel's shared-memory planes: odd, so that
    the column passes hit 32 banks."""
    return n if n % 2 else n + 1


def warp_route(n: int, c: int) -> str:
    """K4's route for (B, n, n, C) images, the one `_warp_cuda` launches:
    "cta" (`basd_warp_cta`, one CTA per sample) when the sample's C planes
    fit one CTA's shared memory (C = 3 to n = 139); else "cluster"
    (`basd_warp_cluster`, a cluster of C CTAs per sample, one plane each)
    for C <= 8; else "plane" (`basd_warp_plane`, one CTA per sample and
    channel)."""
    if not 1 <= n <= MAX_N or c < 1:
        raise ValueError(f"warp kernel takes 1 <= n <= {MAX_N}, C >= 1; got n={n}, C={c}")
    if 4 * c * n * plane_ld(n) <= _MAX_SHARED_BYTES:
        return "cta"
    return "cluster" if c <= _MAX_CLUSTER else "plane"


def pass_bounds(n: int) -> tuple[int, int, int]:
    """Max |delta| per shear pass for an n x n image, covering every
    TrivialAugmentWide op (exactly one op is active per sample): pass 1
    alpha in {paeth, shear} plus trans_x; pass 2 beta in {sin(residual),
    shear} plus trans_y; pass 3 gamma = paeth."""
    cy = (n - 1) / 2.0
    b12 = int(math.ceil(max(_SHEAR_MAX * cy, _TRANS_MAX))) + 1
    b3 = int(math.ceil(_PAETH_MAX * cy)) + 1
    return min(b12, n), min(b12, n), min(b3, n)


def _levels(max_shift: int) -> tuple[int, int, int]:
    """(stride, kmax, fine) of the two-level shift of the plain version."""
    stride = max(2, int(math.ceil(math.sqrt(float(max_shift)))))
    kmax = int(math.ceil(max_shift / stride))
    fine = int(math.ceil(stride / 2.0)) + 1
    return stride, kmax, fine


def rounded_once(fn, x: torch.Tensor) -> torch.Tensor:
    """fn (a torch transcendental) of fp32 `x` in float64, rounded once to
    fp32: the correctly rounded value but for rare double-rounding ties,
    the same bits from every host's libm and from the card. fp32
    `torch.tan`/`torch.sin` differ between hosts by an ulp at some
    TrivialAugment angles."""
    return fn(x.to(torch.float64)).to(torch.float32)


def warp_params(
    angle: torch.Tensor,
    shear_x: torch.Tensor,
    shear_y: torch.Tensor,
    trans_x: torch.Tensor,
    trans_y: torch.Tensor,
    flip: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B, 8) fp32 rows [paeth + shear_x, sin(residual) + shear_y, paeth,
    trans_x, trans_y, k, flip, 0]: the inverse rotation `angle` (radians)
    splits into k quarter-turns and a residual |residual| <= 45 degrees,
    R(residual) = Sx(paeth) Sy(sin residual) Sx(paeth) with
    paeth = -tan(residual / 2).

    The quotient angle / (pi / 2) is a true fp32 division, as in the JAX
    package: at +-135 degrees it sits on the 1.5 tie, and a multiply by a
    rounded reciprocal (what CUDA does for a division by a host scalar)
    can land one ulp off it and pick the other quarter-turn. So pi / 2 is a
    tensor on the angle's device. tan and sin are taken in float64 and
    rounded once (`rounded_once`), so the rows do not depend on the host:
    one ulp of the shear factor moves a pixel by up to n/2 ulps."""
    b = angle.shape[0]
    half_pi = torch.full((), math.pi / 2.0, dtype=torch.float32, device=angle.device)
    quarter = torch.round(angle / half_pi)  # half to even, as jnp.round
    kq = torch.remainder(quarter.to(torch.int32), 4).to(torch.float32)
    residual = angle - quarter * half_pi
    paeth = -rounded_once(torch.tan, residual / 2.0)
    zeros = torch.zeros_like(angle)
    fl = zeros if flip is None else flip.reshape(b).to(torch.float32)
    return torch.stack([paeth + shear_x, rounded_once(torch.sin, residual) + shear_y, paeth,
                        trans_x, trans_y, kq, fl, zeros], dim=-1)


def geometric_warp_plain(images: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """K4's function in torch ops: hflip, quarter-turn and the three shear
    passes as the JAX package's gather-free tap sweeps (`augment`)."""
    # augment imports this module; its warp primitives load at call time
    from basd_tpu_torch.ops.augment import _quarter_turn, _shift_axis, hflip

    n = images.shape[1]
    out = _quarter_turn(hflip(images, params[:, 6] > 0.5), params[:, 5])
    lane = torch.arange(n, dtype=torch.float32, device=images.device) - (n - 1) / 2.0
    p = lambda i: params[:, i, None]
    b1, b2, b3 = pass_bounds(n)
    out = _shift_axis(out, p(0) * lane + p(3), axis=2, max_shift=b1)
    out = _shift_axis(out, p(1) * lane + p(4), axis=1, max_shift=b2)
    return _shift_axis(out, p(2) * lane, axis=2, max_shift=b3)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _warp_cuda(images: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Launch K4 on contiguous fp32 (B, n, n, C) images with (B, 8) params."""
    if images.dtype != torch.float32 or images.ndim != 4:
        raise ValueError("warp kernel takes fp32 (B, n, n, C) images")
    b, n, w, c = images.shape
    if n != w:
        raise ValueError(f"warp kernel takes square images, got {n} x {w}")
    if not 1 <= n <= MAX_N or b < 1 or c < 1:
        raise ValueError(
            f"warp kernel takes 1 <= n <= {MAX_N}, B >= 1, C >= 1; got "
            f"{tuple(images.shape)}")
    if not images.is_contiguous():
        raise ValueError("warp kernel takes contiguous images")
    if (params.shape != (b, 8) or params.dtype != torch.float32
            or not params.is_contiguous() or params.device != images.device):
        raise ValueError("warp params must be contiguous fp32 (B, 8) on the "
                         "images' device")
    out = torch.empty_like(images)
    route = warp_route(n, c)
    launch = getattr(kernels.library("warp"), f"basd_warp_{route}")
    status = launch(
        images.data_ptr(), out.data_ptr(), params.data_ptr(), b, n, c,
        _stream(images),
    )
    kernels.check(status, f"warp route {route}")
    kernels.LAUNCHES["warp"] += 1
    return out


def fused_geometric_warp(
    images: torch.Tensor,  # (B, n, n, C) fp32
    angle: torch.Tensor,  # (B,) inverse-map rotation, radians
    shear_x: torch.Tensor,
    shear_y: torch.Tensor,
    trans_x: torch.Tensor,
    trans_y: torch.Tensor,
    flip: torch.Tensor | None = None,  # (B,) bool hflip mask
) -> torch.Tensor:
    """hflip (optional) then `augment._geometric_warp`: K4 on a CUDA tensor,
    its plain version on a CPU one."""
    if images.device.type not in ("cpu", "cuda"):
        raise ValueError(f"warp runs on cuda or cpu, not {images.device}")
    if images.ndim != 4 or images.shape[1] != images.shape[2]:
        raise ValueError(f"warp takes square (B, n, n, C), got {tuple(images.shape)}")
    params = warp_params(angle, shear_x, shear_y, trans_x, trans_y, flip)
    if images.device.type == "cpu":
        return geometric_warp_plain(images, params)
    return _warp_cuda(images, params)
