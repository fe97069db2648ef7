"""The deterministic (eval) half of `basd_tpu/ops/preprocess.py`: both
train views derived on the device from one uint8 (B, H, W, 3) batch."""

from __future__ import annotations

import torch

from basd_tpu_torch.ops.augment import normalize, resize_bilinear


def to_float(images_u8: torch.Tensor) -> torch.Tensor:
    return images_u8.to(torch.float32) / 255.0


def center_crop_resize(
    images: torch.Tensor, img_size: int, crop_ratio: float
) -> torch.Tensor:
    """Resize(round(img / crop_ratio)) -> CenterCrop(img); the resize is
    skipped when the input already has the resize size."""
    resize_size = round(img_size / crop_ratio)
    if images.shape[1] != resize_size or images.shape[2] != resize_size:
        images = resize_bilinear(images, resize_size, resize_size)
    off = (resize_size - img_size) // 2
    return images[:, off : off + img_size, off : off + img_size, :]


def eval_view(
    images_u8: torch.Tensor, img_size: int, crop_ratio: float, mean, std
) -> torch.Tensor:
    return normalize(
        center_crop_resize(to_float(images_u8), img_size, crop_ratio), mean, std
    )


def dual_view_eval(
    images_u8: torch.Tensor,
    *,
    img_size: int,
    crop_ratio: float,
    teacher_stats: tuple,
    dataset_stats: tuple,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(teacher view, student view): both the eval transform, normalized
    with the teacher's and the dataset's stats."""
    base = center_crop_resize(to_float(images_u8), img_size, crop_ratio)
    return normalize(base, *teacher_stats), normalize(base, *dataset_stats)
