"""On-device image augmentation: the port of `basd_tpu/ops/augment.py`.

Images are float (B, H, W, C) in [0, 1], as in the JAX package. Every
random function is split in two: a sampler (`sample_*`) that draws from a
`torch.Generator` on that generator's device, and a deterministic function
of the draws. The train step feeds the deterministic half from its own
generator; the tests feed it the JAX package's draws.

TrivialAugmentWide sends every square batch through
`warp_kernel.fused_geometric_warp` (kernel K4 on the card, its plain
version on the CPU) with the hflip folded in. Identity parameters give the
input bit for bit, so samples without a geometric op need no select.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from basd_tpu_torch.device import device_constant
from basd_tpu_torch.ops import warp_kernel


@device_constant
def _channel_constant(values: tuple[float, ...], device: torch.device) -> torch.Tensor:
    """Per-channel statistics as fp32 on `device`."""
    return torch.as_tensor(values, dtype=torch.float32, device=device)


def normalize(images: torch.Tensor, mean, std) -> torch.Tensor:
    as_key = lambda v: tuple(float(x) for x in v)
    mean = _channel_constant(as_key(mean), images.device)
    std = _channel_constant(as_key(std), images.device)
    return (images - mean) / std


def _axis_weights(src: torch.Tensor, n_in: int) -> torch.Tensor:
    """(..., n_out) fractional source coords -> (..., n_out, n_in) bilinear
    weights w[.., i, k] = max(0, 1 - |src_i - k|)."""
    grid = torch.arange(n_in, dtype=torch.float32, device=src.device)
    return torch.clamp(1.0 - (src[..., None] - grid).abs(), min=0.0)


def _resample_separable(
    images: torch.Tensor, src_y: torch.Tensor, src_x: torch.Tensor
) -> torch.Tensor:
    """Sample (B, H, W, C) at per-sample axis coords src_y (B, H_out),
    src_x (B, W_out); out-of-range coords clamp at the border."""
    h, w = images.shape[1], images.shape[2]
    wy = _axis_weights(torch.clamp(src_y, 0.0, h - 1.0), h)  # (B, H_out, H)
    wx = _axis_weights(torch.clamp(src_x, 0.0, w - 1.0), w)  # (B, W_out, W)
    out = torch.einsum("bih,bhwc->biwc", wy, images.float())
    return torch.einsum("bjw,biwc->bijc", wx, out)


def resize_bilinear(images: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Half-pixel bilinear resize (torch antialias=False semantics)."""
    b, h, w = images.shape[:3]
    dev = images.device
    sy = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * (h / out_h) - 0.5
    sx = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * (w / out_w) - 0.5
    return _resample_separable(
        images, sy.expand(b, out_h), sx.expand(b, out_w)
    )


def _col(x: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, 1, 1), to broadcast a per-sample value over images."""
    return x.reshape(-1, 1, 1, 1)


# ---------------------------------------------------------------------------
# HFlip and RandomResizedCrop
# ---------------------------------------------------------------------------


def sample_flip(generator: torch.Generator, batch: int, p: float = 0.5) -> torch.Tensor:
    """(B,) bool: flip each sample with probability p."""
    return torch.rand(batch, generator=generator, device=generator.device) < p


def hflip(images: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    return torch.where(_col(flip), images.flip(2), images)


class CropDraws(NamedTuple):
    """RandomResizedCrop draws, each (B, attempts)."""

    area_frac: torch.Tensor  # crop area / image area, uniform in `scale`
    log_ratio: torch.Tensor  # log aspect ratio, uniform in log(`ratio`)
    u_i: torch.Tensor  # top offset as a fraction of the slack, uniform [0, 1)
    u_j: torch.Tensor  # left offset, likewise


def sample_crop(
    generator: torch.Generator,
    batch: int,
    scale: tuple[float, float] = (0.08, 1.0),
    ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    attempts: int = 10,
) -> CropDraws:
    uniform = lambda lo, hi: lo + (hi - lo) * torch.rand(
        (batch, attempts), generator=generator, device=generator.device)
    return CropDraws(
        uniform(*scale),
        uniform(math.log(ratio[0]), math.log(ratio[1])),
        uniform(0.0, 1.0),
        uniform(0.0, 1.0),
    )


def random_resized_crop(
    images: torch.Tensor,
    draws: CropDraws,
    out_size: int,
    ratio: tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> torch.Tensor:
    """torchvision RandomResizedCrop semantics: take the first attempt whose
    crop fits in the image, else the largest in-ratio centre crop."""
    b, h, w = images.shape[:3]
    target_area = (h * w) * draws.area_frac
    aspect = warp_kernel.rounded_once(torch.exp, draws.log_ratio)
    cw = torch.sqrt(target_area * aspect)
    ch = torch.sqrt(target_area / aspect)
    valid = (cw <= w) & (ch <= h)  # (B, attempts)
    top = draws.u_i * (h - ch)
    left = draws.u_j * (w - cw)

    # first valid attempt per sample: argmax returns the first maximum
    idx = valid.to(torch.uint8).argmax(dim=1, keepdim=True)
    any_valid = valid.any(dim=1)
    take = lambda a: a.gather(1, idx)[:, 0]
    ch_s, cw_s, top_s, left_s = take(ch), take(cw), take(top), take(left)

    # fallback: the largest in-ratio rectangle, centred (fp32 as in JAX)
    fb_cw = min(np.float32(w), np.float32(h) * np.float32(ratio[1]))
    fb_ch = min(np.float32(h), np.float32(w) / np.float32(ratio[0]))
    ch_s = torch.where(any_valid, ch_s, float(fb_ch))
    cw_s = torch.where(any_valid, cw_s, float(fb_cw))
    top_s = torch.where(any_valid, top_s, float((h - fb_ch) / np.float32(2.0)))
    left_s = torch.where(any_valid, left_s, float((w - fb_cw) / np.float32(2.0)))

    grid = torch.arange(out_size, dtype=torch.float32, device=images.device)[None, :]
    # a true division on every device (CUDA divides by a host scalar as a
    # multiply by its rounded reciprocal, which would move the sample
    # coordinates by an ulp and the resampled pixels by up to ~1e-6)
    per_px = lambda c: c[:, None] / torch.full_like(c[:, None], out_size)
    ys = (grid + 0.5) * per_px(ch_s) - 0.5 + top_s[:, None]
    xs = (grid + 0.5) * per_px(cw_s) - 0.5 + left_s[:, None]
    return _resample_separable(images, ys, xs)


# ---------------------------------------------------------------------------
# The geometric warp: quarter-turn + Paeth three-shear, gather-free. These
# are the plain version of kernel K4 (`warp_kernel.geometric_warp_plain`).
# ---------------------------------------------------------------------------


def _quarter_turn(images: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-sample lossless rotation by k * 90 degrees (k in {0, 1, 2, 3})."""
    r1 = images.transpose(1, 2).flip(1)  # 90 ccw
    r2 = images.flip(1).flip(2)  # 180
    r3 = images.transpose(1, 2).flip(2)  # 270 ccw
    stack = torch.stack([images, r1, r2, r3])  # (4, B, H, W, C)
    return stack[k.long(), torch.arange(images.shape[0], device=images.device)]


def _shift_axis_taps(
    images: torch.Tensor,
    delta: torch.Tensor,
    axis: int,
    taps: list[int],
    *,
    nearest: bool,
    stride: int = 1,
) -> torch.Tensor:
    """out[x] = interp(in[x + delta]) over the given static tap offsets, with
    zero fill: indicator weights (`nearest`, the coarse level of the
    two-level shift) or bilinear tent weights."""
    n = images.shape[axis]
    t0 = max(abs(t) for t in taps)
    padded = F.pad(images, (0, 0) * (images.ndim - 1 - axis) + (t0, t0))
    shape = [images.shape[0], 1, 1, 1]
    shape[1 if axis == 2 else 2] = delta.shape[1]
    acc = torch.zeros_like(images)
    for t in taps:
        if nearest:
            wgt = ((delta - t).abs() <= stride / 2.0).to(torch.float32)
        else:
            wgt = torch.clamp(1.0 - (delta - t).abs(), min=0.0)
        acc = acc + wgt.reshape(shape) * padded.narrow(axis, t0 + t, n)
    return acc


def _shift_axis(images: torch.Tensor, delta: torch.Tensor, axis: int,
                max_shift: int) -> torch.Tensor:
    """Shift rows (axis=2, delta (B, H)) or columns (axis=1, delta (B, W))
    by a continuous per-line amount, bilinear with zero fill:
    out[x] = in[x + delta]. Up to 40 pixels one dense tap sweep; beyond, a
    nearest coarse shift by multiples of a stride and a bilinear fine shift
    of the residual, which together equal the dense sweep."""
    if max_shift <= 40:
        taps = list(range(-max_shift, max_shift + 1))
        return _shift_axis_taps(images, delta, axis, taps, nearest=False)

    stride, kmax, fine = warp_kernel._levels(max_shift)
    k = torch.clamp(torch.round(delta / stride), -kmax, kmax)
    residual = delta - k * stride
    # the coarse intermediate extends by the fine range, so the fine pass
    # reads true pixels and not a zero pad near the boundary
    n = images.shape[axis]
    ext = F.pad(images, (0, 0) * (images.ndim - 1 - axis) + (fine, fine))
    coarse_taps = [stride * j for j in range(-kmax, kmax + 1)]
    out = _shift_axis_taps(ext, k * stride, axis, coarse_taps, nearest=True,
                           stride=stride)
    out = _shift_axis_taps(out, residual, axis, list(range(-fine, fine + 1)),
                           nearest=False)
    return out.narrow(axis, fine, n)


def _geometric_warp(
    images: torch.Tensor,
    angle: torch.Tensor,  # (B,) inverse-map rotation, radians
    shear_x: torch.Tensor,  # (B,) inverse-map x shear
    shear_y: torch.Tensor,  # (B,) inverse-map y shear
    trans_x: torch.Tensor,  # (B,) inverse-map x translation, pixels
    trans_y: torch.Tensor,  # (B,) inverse-map y translation, pixels
) -> torch.Tensor:
    """Rotate / shear / translate square images: a quarter-turn plus the
    Paeth three-shear of the residual rotation (|residual| <= 45 degrees),
    with the shears and translations folded into the three passes. Exactly
    one op is active per TrivialAugment sample, so the passes compose
    without cross terms."""
    params = warp_kernel.warp_params(angle, shear_x, shear_y, trans_x, trans_y)
    return warp_kernel.geometric_warp_plain(images, params)


def _affine_warp(images: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """Warp (B, H, W, C) by per-sample inverse affine (B, 2, 3) matrices
    that map output (y, x, 1), about the image centre, to input coords:
    bilinear with zero fill (a gather). The non-square branch of
    TrivialAugmentWide."""
    b, h, w, c = images.shape
    dev = images.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    coords = torch.stack([yy - cy, xx - cx, torch.ones_like(yy)])  # (3, H, W)
    src = torch.einsum("bik,khw->bihw", mats, coords)
    src_y, src_x = src[:, 0] + cy, src[:, 1] + cx  # (B, H, W)

    def taps(src):
        lower = torch.floor(src)
        upper_w = src - lower
        return [(lower.long(), 1.0 - upper_w), (lower.long() + 1, upper_w)]

    flat = images.reshape(b, h * w, c)
    out = torch.zeros_like(images)
    for iy, wy in taps(src_y):
        for ix, wx in taps(src_x):
            valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
            val = flat.gather(1, idx.reshape(b, h * w, 1).expand(-1, -1, c))
            val = torch.where(valid[..., None], val.reshape(b, h, w, c), 0.0)
            out = out + (wy * wx)[..., None] * val
    return out


def _inverse_affine(angle, shear_x, shear_y, trans_x, trans_y) -> torch.Tensor:
    """(B, 2, 3) inverse maps (out -> in, acting on (y, x, 1)) of
    rotate + shear + translate."""
    cos = warp_kernel.rounded_once(torch.cos, angle)
    sin = warp_kernel.rounded_once(torch.sin, angle)
    a11 = cos - sin * shear_y
    a12 = cos * shear_x - sin
    a21 = sin + cos * shear_y
    a22 = sin * shear_x + cos
    det = a11 * a22 - a12 * a21
    inv11, inv12 = a22 / det, -a12 / det
    inv21, inv22 = -a21 / det, a11 / det
    return torch.stack([
        torch.stack([inv22, inv21, -(inv22 * trans_y + inv21 * trans_x)], -1),
        torch.stack([inv12, inv11, -(inv12 * trans_y + inv11 * trans_x)], -1),
    ], dim=-2)


# ---------------------------------------------------------------------------
# Photometric and histogram ops
# ---------------------------------------------------------------------------

_GRAY = (0.299, 0.587, 0.114)


def _gray(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W) luma, as elementwise products and sums (the
    same rounding on every device; no matmul precision mode applies)."""
    r, g, b = images.unbind(-1)
    return r * _GRAY[0] + g * _GRAY[1] + b * _GRAY[2]


def _blur3(images: torch.Tensor) -> torch.Tensor:
    """PIL SMOOTH 3x3 blur used by sharpness (weights 1/13, centre 5/13);
    the border pixels stay unblurred, as in torchvision. Written as shifted
    sums in fp32, so no convolution (and no TF32 mode) is involved."""
    h, w = images.shape[1], images.shape[2]
    if h < 3 or w < 3:
        return images
    edge, centre = float(np.float32(1) / 13), float(np.float32(5) / 13)
    acc = None
    for dy in range(3):
        for dx in range(3):
            term = images[:, dy : h - 2 + dy, dx : w - 2 + dx, :] * (
                centre if dy == dx == 1 else edge)
            acc = term if acc is None else acc + term
    out = images.clone()
    out[:, 1:-1, 1:-1, :] = acc
    return out


def _equalize(images: torch.Tensor) -> torch.Tensor:
    """PIL-style histogram equalization per image and channel in uint8
    space, bit-exact against PIL: truncation to uint8 as
    clip(x * 255, 0, 255) then a cast, integer LUT arithmetic with floor
    division. The histogram is a scatter-add per (sample, channel)."""
    b, h, w, c = images.shape
    u8 = torch.clamp(images * 255.0, 0, 255).to(torch.int64)
    flat = u8.permute(0, 3, 1, 2).reshape(b * c, h * w)
    rows = torch.arange(b * c, device=images.device)[:, None] * 256
    hist = torch.zeros(b * c * 256, dtype=torch.int64, device=images.device)
    hist.scatter_add_(0, (flat + rows).reshape(-1), torch.ones_like(flat).reshape(-1))
    hist = hist.reshape(b * c, 256)
    cum = hist.cumsum(dim=-1)

    last_nz = 255 - (hist > 0).flip(-1).to(torch.uint8).argmax(dim=-1)
    total = cum[:, -1]
    last_count = hist.gather(1, last_nz[:, None])[:, 0]
    step = (total - last_count) // 255  # (BC,)

    ramp = torch.arange(256, device=images.device)
    lut = torch.where(
        (step > 0)[:, None],
        torch.clamp((cum - hist + (step // 2)[:, None])
                    // torch.clamp(step, min=1)[:, None], 0, 255),
        ramp[None, :],
    )  # (BC, 256)
    out = lut.gather(1, flat).to(torch.float32)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1) / 255.0


def _equalize_masked(images: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """where(mask, _equalize(images), images). The histogram runs over the
    whole batch: selecting the masked subset would read its size back to
    the host, and the whole batch costs little on the card."""
    return torch.where(_col(mask), _equalize(images), images)


def _autocontrast(images: torch.Tensor) -> torch.Tensor:
    lo = images.amin(dim=(1, 2), keepdim=True)
    hi = images.amax(dim=(1, 2), keepdim=True)
    scale = torch.where(hi > lo, 1.0 / (hi - lo), 1.0)
    return torch.clamp((images - lo) * scale, 0.0, 1.0)


# ---------------------------------------------------------------------------
# TrivialAugmentWide
# ---------------------------------------------------------------------------

NUM_OPS = 14
(
    OP_IDENTITY,
    OP_SHEAR_X,
    OP_SHEAR_Y,
    OP_TRANSLATE_X,
    OP_TRANSLATE_Y,
    OP_ROTATE,
    OP_BRIGHTNESS,
    OP_COLOR,
    OP_CONTRAST,
    OP_SHARPNESS,
    OP_POSTERIZE,
    OP_SOLARIZE,
    OP_AUTOCONTRAST,
    OP_EQUALIZE,
) = range(NUM_OPS)  # the geometric ops are SHEAR_X ... ROTATE


class AugmentDraws(NamedTuple):
    """TrivialAugmentWide draws, each (B,)."""

    op: torch.Tensor  # int64 in [0, NUM_OPS)
    mag: torch.Tensor  # fp32 magnitude in {0, 1/30, ..., 30/30}
    sign: torch.Tensor  # fp32 -1 or +1


def sample_trivial_augment(generator: torch.Generator, batch: int) -> AugmentDraws:
    """One op per image, uniform over 14; a magnitude uniform over 31 bins;
    a sign with p = 0.5."""
    dev = generator.device
    op = torch.randint(0, NUM_OPS, (batch,), generator=generator, device=dev)
    mag = torch.randint(0, 31, (batch,), generator=generator, device=dev).float() / 30.0
    sign = torch.where(
        torch.rand(batch, generator=generator, device=dev) < 0.5, 1.0, -1.0)
    return AugmentDraws(op, mag, sign)


def trivial_augment_wide(
    images: torch.Tensor, draws: AugmentDraws, flip_mask: torch.Tensor | None = None
) -> torch.Tensor:
    """TrivialAugmentWide (Mueller & Hutter 2021) with torchvision's wide
    ranges (shear 0.99, translate 32 px, rotate 135 degrees, colour factors
    0.99, posterize >= 2 bits, solarize over the full range): ONE op per
    image, every op applied to the whole batch with neutral parameters for
    the images that did not draw it.

    `flip_mask` (B,) bool: an hflip applied BEFORE the op; on square images
    the warp kernel folds it into its load."""
    op, mag, sign = draws
    sm = sign * mag
    is_op = lambda o: op == o

    shear_x = torch.where(is_op(OP_SHEAR_X), sm * 0.99, 0.0)
    shear_y = torch.where(is_op(OP_SHEAR_Y), sm * 0.99, 0.0)
    trans_x = torch.where(is_op(OP_TRANSLATE_X), sm * 32.0, 0.0)
    trans_y = torch.where(is_op(OP_TRANSLATE_Y), sm * 32.0, 0.0)
    angle = torch.where(is_op(OP_ROTATE), sm * 135.0, 0.0) * (math.pi / 180.0)

    if images.shape[1] == images.shape[2]:
        out = warp_kernel.fused_geometric_warp(
            images.contiguous(), angle, shear_x, shear_y, trans_x, trans_y,
            flip_mask,
        )
    else:
        if flip_mask is not None:
            images = hflip(images, flip_mask)
        geo = (op >= OP_SHEAR_X) & (op <= OP_ROTATE)
        mats = _inverse_affine(angle, shear_x, shear_y, trans_x, trans_y)
        out = torch.where(_col(geo), _affine_warp(images, mats), images)

    factor = 1.0 + sm * 0.99
    f_bright = torch.where(is_op(OP_BRIGHTNESS), factor, 1.0)
    out = torch.clamp(out * _col(f_bright), 0.0, 1.0)

    gray = _gray(out)[..., None]
    f_color = torch.where(is_op(OP_COLOR), factor, 1.0)
    out = torch.clamp(gray + _col(f_color) * (out - gray), 0.0, 1.0)

    mean_gray = _col(_gray(out).mean(dim=(1, 2)))
    f_contrast = torch.where(is_op(OP_CONTRAST), factor, 1.0)
    out = torch.clamp(mean_gray + _col(f_contrast) * (out - mean_gray), 0.0, 1.0)

    blurred = _blur3(out)
    f_sharp = torch.where(is_op(OP_SHARPNESS), factor, 1.0)
    out = torch.clamp(blurred + _col(f_sharp) * (out - blurred), 0.0, 1.0)

    # posterize to 8 - round(6 mag) bits, in the JAX package's op order so
    # that the floor lands on the same side
    bits = 8.0 - torch.round(mag * 6.0)
    step = _col(256.0 / torch.exp2(bits))
    posterized = torch.floor(out * 255.0 / step) * step / 255.0
    out = torch.where(_col(is_op(OP_POSTERIZE)), posterized, out)

    # solarize: invert at and above the threshold; neutral threshold 2 > 1
    thresh = _col(torch.where(is_op(OP_SOLARIZE), 1.0 - mag, 2.0))
    out = torch.where(out >= thresh, 1.0 - out, out)

    out = torch.where(_col(is_op(OP_AUTOCONTRAST)), _autocontrast(out), out)
    return _equalize_masked(out, is_op(OP_EQUALIZE))
