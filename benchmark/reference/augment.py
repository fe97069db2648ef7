"""The step's two views and mixed targets in plain torch, float32.

A frozen copy of the port's plain paths (the views, RandomResizedCrop,
TrivialAugmentWide with its three-shear warp, MixUp/CutMix), so that the
reference works the views out again from the raw uint8 batch and the
step's generator. The samplers make the same calls, in the same order and
shapes, as the port's, so a generator seeded alike gives the same draws.
Only square images are taken: every configuration of the benchmark has
them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

_F32 = torch.float32


# ---------------------------------------------------------------- draws


class CropDraws(NamedTuple):
    area_frac: torch.Tensor
    log_ratio: torch.Tensor
    u_i: torch.Tensor
    u_j: torch.Tensor


class AugmentDraws(NamedTuple):
    op: torch.Tensor
    mag: torch.Tensor
    sign: torch.Tensor


class MixDraws(NamedTuple):
    use_cutmix: torch.Tensor
    lam: torch.Tensor
    box_y: torch.Tensor
    box_x: torch.Tensor


class StepDraws(NamedTuple):
    crop: CropDraws
    flip: torch.Tensor
    augment: AugmentDraws
    mix: MixDraws


NUM_OPS = 14
(OP_IDENTITY, OP_SHEAR_X, OP_SHEAR_Y, OP_TRANSLATE_X, OP_TRANSLATE_Y, OP_ROTATE,
 OP_BRIGHTNESS, OP_COLOR, OP_CONTRAST, OP_SHARPNESS, OP_POSTERIZE, OP_SOLARIZE,
 OP_AUTOCONTRAST, OP_EQUALIZE) = range(NUM_OPS)


def sample_step_draws(generator: torch.Generator, batch: int) -> StepDraws:
    """Crop (4 x (B, 10) uniforms), flip (B), TrivialAugment (op, magnitude
    bin, sign) and the per-batch MixUp/CutMix draws, in that order."""
    dev = generator.device
    attempts = 10
    uniform = lambda lo, hi: lo + (hi - lo) * torch.rand(
        (batch, attempts), generator=generator, device=dev)
    crop = CropDraws(uniform(0.08, 1.0),
                     uniform(math.log(3.0 / 4.0), math.log(4.0 / 3.0)),
                     uniform(0.0, 1.0), uniform(0.0, 1.0))
    flip = torch.rand(batch, generator=generator, device=dev) < 0.5
    op = torch.randint(0, NUM_OPS, (batch,), generator=generator, device=dev)
    mag = torch.randint(0, 31, (batch,), generator=generator, device=dev).float() / 30.0
    sign = torch.where(torch.rand(batch, generator=generator, device=dev) < 0.5, 1.0, -1.0)
    rand = lambda *shape: torch.rand(shape, generator=generator, device=dev)
    use_cutmix = rand() < 0.5
    lam = rand()
    box_y, box_x = rand(2).unbind()
    return StepDraws(crop, flip, AugmentDraws(op, mag, sign),
                     MixDraws(use_cutmix, lam, box_y, box_x))


# ---------------------------------------------------------------- resampling


def normalize(images, mean, std):
    m = torch.tensor(mean, dtype=_F32, device=images.device)
    s = torch.tensor(std, dtype=_F32, device=images.device)
    return (images - m) / s


def _axis_weights(src, n_in):
    grid = torch.arange(n_in, dtype=_F32, device=src.device)
    return torch.clamp(1.0 - (src[..., None] - grid).abs(), min=0.0)


def _resample_separable(images, src_y, src_x):
    h, w = images.shape[1], images.shape[2]
    wy = _axis_weights(torch.clamp(src_y, 0.0, h - 1.0), h)
    wx = _axis_weights(torch.clamp(src_x, 0.0, w - 1.0), w)
    out = torch.einsum("bih,bhwc->biwc", wy, images.float())
    return torch.einsum("bjw,biwc->bijc", wx, out)


def resize_bilinear(images, out_h, out_w):
    b, h, w = images.shape[:3]
    dev = images.device
    sy = (torch.arange(out_h, dtype=_F32, device=dev) + 0.5) * (h / out_h) - 0.5
    sx = (torch.arange(out_w, dtype=_F32, device=dev) + 0.5) * (w / out_w) - 0.5
    return _resample_separable(images, sy.expand(b, out_h), sx.expand(b, out_w))


def center_crop_resize(images, img_size, crop_ratio):
    resize_size = round(img_size / crop_ratio)
    if images.shape[1] != resize_size or images.shape[2] != resize_size:
        images = resize_bilinear(images, resize_size, resize_size)
    off = (resize_size - img_size) // 2
    return images[:, off:off + img_size, off:off + img_size, :]


def _col(x):
    return x.reshape(-1, 1, 1, 1)


def rounded_once(fn, x):
    return fn(x.to(torch.float64)).to(_F32)


def random_resized_crop(images, draws: CropDraws, out_size):
    b, h, w = images.shape[:3]
    target_area = (h * w) * draws.area_frac
    aspect = rounded_once(torch.exp, draws.log_ratio)
    cw = torch.sqrt(target_area * aspect)
    ch = torch.sqrt(target_area / aspect)
    valid = (cw <= w) & (ch <= h)
    top = draws.u_i * (h - ch)
    left = draws.u_j * (w - cw)
    idx = valid.to(torch.uint8).argmax(dim=1, keepdim=True)
    any_valid = valid.any(dim=1)
    take = lambda a: a.gather(1, idx)[:, 0]
    ch_s, cw_s, top_s, left_s = take(ch), take(cw), take(top), take(left)
    fb_cw = min(np.float32(w), np.float32(h) * np.float32(4.0 / 3.0))
    fb_ch = min(np.float32(h), np.float32(w) / np.float32(3.0 / 4.0))
    ch_s = torch.where(any_valid, ch_s, float(fb_ch))
    cw_s = torch.where(any_valid, cw_s, float(fb_cw))
    top_s = torch.where(any_valid, top_s, float((h - fb_ch) / np.float32(2.0)))
    left_s = torch.where(any_valid, left_s, float((w - fb_cw) / np.float32(2.0)))
    grid = torch.arange(out_size, dtype=_F32, device=images.device)[None, :]
    per_px = lambda c: c[:, None] / torch.full_like(c[:, None], out_size)
    ys = (grid + 0.5) * per_px(ch_s) - 0.5 + top_s[:, None]
    xs = (grid + 0.5) * per_px(cw_s) - 0.5 + left_s[:, None]
    return _resample_separable(images, ys, xs)


# ---------------------------------------------------------------- the warp


_PAETH_MAX = math.tan(math.pi / 8.0)


def _pass_bounds(n):
    cy = (n - 1) / 2.0
    b12 = int(math.ceil(max(0.99 * cy, 32.0))) + 1
    b3 = int(math.ceil(_PAETH_MAX * cy)) + 1
    return min(b12, n), min(b12, n), min(b3, n)


def _levels(max_shift):
    stride = max(2, int(math.ceil(math.sqrt(float(max_shift)))))
    kmax = int(math.ceil(max_shift / stride))
    fine = int(math.ceil(stride / 2.0)) + 1
    return stride, kmax, fine


def _warp_params(angle, shear_x, shear_y, trans_x, trans_y, flip):
    half_pi = torch.full((), math.pi / 2.0, dtype=_F32, device=angle.device)
    quarter = torch.round(angle / half_pi)
    kq = torch.remainder(quarter.to(torch.int32), 4).to(_F32)
    residual = angle - quarter * half_pi
    paeth = -rounded_once(torch.tan, residual / 2.0)
    zeros = torch.zeros_like(angle)
    return torch.stack([paeth + shear_x, rounded_once(torch.sin, residual) + shear_y,
                        paeth, trans_x, trans_y, kq, flip.to(_F32), zeros], dim=-1)


def _quarter_turn(images, k):
    r1 = images.transpose(1, 2).flip(1)
    r2 = images.flip(1).flip(2)
    r3 = images.transpose(1, 2).flip(2)
    stack = torch.stack([images, r1, r2, r3])
    return stack[k.long(), torch.arange(images.shape[0], device=images.device)]


def _shift_taps(images, delta, axis, taps, *, nearest, stride=1):
    n = images.shape[axis]
    t0 = max(abs(t) for t in taps)
    padded = F.pad(images, (0, 0) * (images.ndim - 1 - axis) + (t0, t0))
    shape = [images.shape[0], 1, 1, 1]
    shape[1 if axis == 2 else 2] = delta.shape[1]
    acc = torch.zeros_like(images)
    for t in taps:
        if nearest:
            wgt = ((delta - t).abs() <= stride / 2.0).to(_F32)
        else:
            wgt = torch.clamp(1.0 - (delta - t).abs(), min=0.0)
        acc = acc + wgt.reshape(shape) * padded.narrow(axis, t0 + t, n)
    return acc


def _shift_axis(images, delta, axis, max_shift):
    """out[x] = in[x + delta], bilinear with zero fill, per line."""
    if max_shift <= 40:
        return _shift_taps(images, delta, axis, list(range(-max_shift, max_shift + 1)),
                           nearest=False)
    stride, kmax, fine = _levels(max_shift)
    k = torch.clamp(torch.round(delta / stride), -kmax, kmax)
    residual = delta - k * stride
    n = images.shape[axis]
    ext = F.pad(images, (0, 0) * (images.ndim - 1 - axis) + (fine, fine))
    out = _shift_taps(ext, k * stride, axis, [stride * j for j in range(-kmax, kmax + 1)],
                      nearest=True, stride=stride)
    out = _shift_taps(out, residual, axis, list(range(-fine, fine + 1)), nearest=False)
    return out.narrow(axis, fine, n)


def geometric_warp(images, angle, shear_x, shear_y, trans_x, trans_y, flip):
    """hflip, a quarter-turn and the Paeth three-shear of the residual
    rotation, with the shears and translations folded into the passes."""
    params = _warp_params(angle, shear_x, shear_y, trans_x, trans_y, flip)
    n = images.shape[1]
    flipped = torch.where(_col(params[:, 6] > 0.5), images.flip(2), images)
    out = _quarter_turn(flipped, params[:, 5])
    lane = torch.arange(n, dtype=_F32, device=images.device) - (n - 1) / 2.0
    p = lambda i: params[:, i, None]
    b1, b2, b3 = _pass_bounds(n)
    out = _shift_axis(out, p(0) * lane + p(3), axis=2, max_shift=b1)
    out = _shift_axis(out, p(1) * lane + p(4), axis=1, max_shift=b2)
    return _shift_axis(out, p(2) * lane, axis=2, max_shift=b3)


# ---------------------------------------------------------------- photometric

_GRAY = (0.299, 0.587, 0.114)


def _gray(images):
    r, g, b = images.unbind(-1)
    return r * _GRAY[0] + g * _GRAY[1] + b * _GRAY[2]


def _blur3(images):
    h, w = images.shape[1], images.shape[2]
    if h < 3 or w < 3:
        return images
    edge, centre = float(np.float32(1) / 13), float(np.float32(5) / 13)
    acc = None
    for dy in range(3):
        for dx in range(3):
            term = images[:, dy:h - 2 + dy, dx:w - 2 + dx, :] * (
                centre if dy == dx == 1 else edge)
            acc = term if acc is None else acc + term
    out = images.clone()
    out[:, 1:-1, 1:-1, :] = acc
    return out


def _equalize(images):
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
    step = (total - last_count) // 255
    ramp = torch.arange(256, device=images.device)
    lut = torch.where((step > 0)[:, None],
                      torch.clamp((cum - hist + (step // 2)[:, None])
                                  // torch.clamp(step, min=1)[:, None], 0, 255),
                      ramp[None, :])
    out = lut.gather(1, flat).to(_F32)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1) / 255.0


def _autocontrast(images):
    lo = images.amin(dim=(1, 2), keepdim=True)
    hi = images.amax(dim=(1, 2), keepdim=True)
    scale = torch.where(hi > lo, 1.0 / (hi - lo), 1.0)
    return torch.clamp((images - lo) * scale, 0.0, 1.0)


def trivial_augment_wide(images, draws: AugmentDraws, flip):
    """One op per image (torchvision's wide ranges), after an hflip."""
    op, mag, sign = draws
    if images.shape[1] != images.shape[2]:
        raise ValueError("the reference takes square images")
    sm = sign * mag
    is_op = lambda o: op == o
    shear_x = torch.where(is_op(OP_SHEAR_X), sm * 0.99, 0.0)
    shear_y = torch.where(is_op(OP_SHEAR_Y), sm * 0.99, 0.0)
    trans_x = torch.where(is_op(OP_TRANSLATE_X), sm * 32.0, 0.0)
    trans_y = torch.where(is_op(OP_TRANSLATE_Y), sm * 32.0, 0.0)
    angle = torch.where(is_op(OP_ROTATE), sm * 135.0, 0.0) * (math.pi / 180.0)
    out = geometric_warp(images.contiguous(), angle, shear_x, shear_y, trans_x, trans_y,
                         flip)

    factor = 1.0 + sm * 0.99
    out = torch.clamp(out * _col(torch.where(is_op(OP_BRIGHTNESS), factor, 1.0)), 0.0, 1.0)
    gray = _gray(out)[..., None]
    f_color = torch.where(is_op(OP_COLOR), factor, 1.0)
    out = torch.clamp(gray + _col(f_color) * (out - gray), 0.0, 1.0)
    mean_gray = _col(_gray(out).mean(dim=(1, 2)))
    f_contrast = torch.where(is_op(OP_CONTRAST), factor, 1.0)
    out = torch.clamp(mean_gray + _col(f_contrast) * (out - mean_gray), 0.0, 1.0)
    blurred = _blur3(out)
    f_sharp = torch.where(is_op(OP_SHARPNESS), factor, 1.0)
    out = torch.clamp(blurred + _col(f_sharp) * (out - blurred), 0.0, 1.0)
    bits = 8.0 - torch.round(mag * 6.0)
    step = _col(256.0 / torch.exp2(bits))
    posterized = torch.floor(out * 255.0 / step) * step / 255.0
    out = torch.where(_col(is_op(OP_POSTERIZE)), posterized, out)
    thresh = _col(torch.where(is_op(OP_SOLARIZE), 1.0 - mag, 2.0))
    out = torch.where(out >= thresh, 1.0 - out, out)
    out = torch.where(_col(is_op(OP_AUTOCONTRAST)), _autocontrast(out), out)
    return torch.where(_col(is_op(OP_EQUALIZE)), _equalize(out), out)


def mixup_cutmix(images, labels, draws: MixDraws, num_classes):
    """One of MixUp or CutMix for the whole batch, against the roll-by-1
    neighbour, with soft targets of the effective lambda."""
    use_cutmix, lam, box_y, box_x = draws
    onehot = F.one_hot(labels.long(), num_classes).to(_F32)
    rolled_images = torch.roll(images, 1, dims=0)
    rolled_targets = torch.roll(onehot, 1, dims=0)
    mixed_mixup = lam * images + (1.0 - lam) * rolled_images
    h, w = images.shape[1], images.shape[2]
    cut = torch.sqrt(1.0 - lam)
    ch, cw = cut * h, cut * w
    cy, cx = box_y * h, box_x * w
    y0 = torch.clamp(cy - ch / 2.0, 0.0, h)
    y1 = torch.clamp(cy + ch / 2.0, 0.0, h)
    x0 = torch.clamp(cx - cw / 2.0, 0.0, w)
    x1 = torch.clamp(cx + cw / 2.0, 0.0, w)
    yy = torch.arange(h, dtype=_F32, device=images.device)[:, None]
    xx = torch.arange(w, dtype=_F32, device=images.device)[None, :]
    box = ((yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1))[None, :, :, None]
    mixed_cutmix = torch.where(box, rolled_images, images)
    lam_cutmix = 1.0 - ((y1 - y0) * (x1 - x0)) / (h * w)
    images_out = torch.where(use_cutmix, mixed_cutmix, mixed_mixup)
    lam_eff = torch.where(use_cutmix, lam_cutmix, lam)
    return images_out, lam_eff * onehot + (1.0 - lam_eff) * rolled_targets


def views(images_u8, labels, draws: StepDraws, *, img_size, crop_ratio, teacher_stats,
          dataset_stats, num_classes):
    """(teacher view, student view, soft targets) of one step."""
    x = images_u8.to(_F32) / 255.0
    clean = normalize(center_crop_resize(x, img_size, crop_ratio), *teacher_stats)
    aug = torch.clamp(random_resized_crop(x, draws.crop, img_size), 0.0, 1.0)
    aug = trivial_augment_wide(aug, draws.augment, draws.flip)
    student, targets = mixup_cutmix(normalize(aug, *dataset_stats), labels, draws.mix,
                                    num_classes)
    return clean, student, targets
