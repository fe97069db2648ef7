"""Frozen teacher construction and intermediate extraction
(`basd_tpu/models/teacher.py`, ViT family). Weights are random, drawn from
a seed; converted checkpoints load through `models.convert`."""

from __future__ import annotations

from typing import NamedTuple

import torch

from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.models.specs import ModelSpec, resolve_preset
from basd_tpu_torch.models.vit import VisionTransformer, ViTConfig


class Teacher(NamedTuple):
    spec: ModelSpec
    module: VisionTransformer  # captures every layer; frozen
    img_size: int
    num_tokens: int
    mean: tuple[float, float, float]
    std: tuple[float, float, float]


def build_teacher_module(
    spec: ModelSpec, img_size: int, dtype=torch.bfloat16
) -> VisionTransformer:
    if spec.family != "vit":
        raise NotImplementedError(
            f"{spec.family} teachers are not ported yet (ROADMAP M6: CNN "
            "teachers)"
        )
    cfg = ViTConfig(
        img_size=img_size,
        patch_size=spec.patch_size,
        embed_dim=spec.embed_dim,
        depth=spec.depth,
        num_heads=spec.num_heads,
        mlp_ratio=spec.mlp_ratio,
        num_classes=0,
        drop_path_rate=0.0,
        has_cls_token=spec.has_cls_token,
        layer_scale_init=spec.layer_scale_init,
        dtype=dtype,
    )
    return VisionTransformer(cfg, capture_layers=tuple(range(spec.depth)))


def load_teacher(
    model_name: str,
    img_size: int,
    *,
    seed: int = 0,
    dtype=torch.bfloat16,
    device=None,
    mean: tuple[float, float, float] | None = None,
    std: tuple[float, float, float] | None = None,
) -> Teacher:
    """Build a frozen, randomly initialized teacher on `device` (the CUDA
    card by default). Normalization stats default to the preset's."""
    dev = resolve_device(device)
    spec = resolve_preset(model_name)
    module = build_teacher_module(spec, img_size, dtype=dtype)
    module.init_weights(seed)
    module = module.to(dev).eval().requires_grad_(False)
    num_tokens = spec.num_tokens(img_size)
    print(
        f"teacher_loaded model={model_name} embed_dim={spec.embed_dim} "
        f"depth={spec.depth} heads={spec.num_heads} num_tokens={num_tokens} "
        f"device={dev}"
    )
    return Teacher(
        spec=spec,
        module=module,
        img_size=img_size,
        num_tokens=num_tokens,
        mean=tuple(mean if mean is not None else spec.norm_mean),
        std=tuple(std if std is not None else spec.norm_std),
    )


@torch.no_grad()
def extract_intermediates(
    teacher: Teacher, x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """All-layer tokens (L, B, N, D) and attention importance (L, B, N),
    without gradient."""
    out = teacher.module(x, train=False)
    return out.tokens, out.importance
