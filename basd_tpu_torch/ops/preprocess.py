"""Both train views on the device from one uint8 (B, H, W, 3) batch: the
port of `basd_tpu/ops/preprocess.py`."""

from __future__ import annotations

from typing import NamedTuple

import torch

from basd_tpu_torch.ops.augment import (
    AugmentDraws,
    CropDraws,
    normalize,
    random_resized_crop,
    resize_bilinear,
    sample_crop,
    sample_flip,
    sample_trivial_augment,
    trivial_augment_wide,
)


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


class ViewDraws(NamedTuple):
    """The random draws of one `dual_view` call."""

    crop: CropDraws
    flip: torch.Tensor  # (B,) bool
    augment: AugmentDraws


def sample_view_draws(generator: torch.Generator, batch: int) -> ViewDraws:
    return ViewDraws(
        sample_crop(generator, batch),
        sample_flip(generator, batch),
        sample_trivial_augment(generator, batch),
    )


def dual_view(
    images_u8: torch.Tensor,
    draws: ViewDraws,
    *,
    img_size: int,
    crop_ratio: float,
    teacher_stats: tuple,
    dataset_stats: tuple,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(clean, augmented) train views. clean: the eval transform with the
    teacher's normalization (feeds the frozen teacher). augmented:
    RandomResizedCrop, clip, hflip, TrivialAugmentWide and the dataset's
    normalization (feeds the student); the hflip is folded into the
    augment's warp."""
    x = to_float(images_u8)
    clean = normalize(center_crop_resize(x, img_size, crop_ratio), *teacher_stats)
    aug = torch.clamp(random_resized_crop(x, draws.crop, img_size), 0.0, 1.0)
    aug = trivial_augment_wide(aug, draws.augment, flip_mask=draws.flip)
    return clean, normalize(aug, *dataset_stats)
