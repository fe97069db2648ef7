"""The eval half of `basd_tpu/ops/augment.py`: normalization and the
separable bilinear resampler. Images are float (B, H, W, C), as in the
JAX package. The random train-time augmentations (TrivialAugmentWide and
its warp kernel) come with the augmented input path."""

from __future__ import annotations

import torch


def normalize(images: torch.Tensor, mean, std) -> torch.Tensor:
    mean = torch.as_tensor(mean, dtype=torch.float32, device=images.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=images.device)
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
