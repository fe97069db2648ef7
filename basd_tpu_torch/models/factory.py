"""Student construction (`basd_tpu/models/factory.py:create_student`)."""

from __future__ import annotations

import torch

from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.models.specs import resolve_preset
from basd_tpu_torch.models.vit import VisionTransformer, ViTConfig


def create_student(
    preset: str,
    *,
    num_classes: int,
    drop_path_rate: float,
    img_size: int,
    arch_overrides: dict | None = None,
    capture_layers: tuple[int, ...] = (),
    dtype: torch.dtype = torch.bfloat16,
    device=None,
    seed: int = 0,
) -> tuple[VisionTransformer, ViTConfig]:
    """Build the student ViT from a preset plus `arch_overrides`, with
    weights drawn from `seed`, on `device` (the CUDA card by default)."""
    dev = resolve_device(device)
    spec = resolve_preset(preset)
    if spec.family != "vit":
        raise ValueError("students are ViTs (reference student_preset=deit_*)")
    overrides = dict(arch_overrides or {})
    cfg = ViTConfig(
        img_size=img_size,
        patch_size=overrides.pop("patch_size", spec.patch_size),
        embed_dim=overrides.pop("embed_dim", spec.embed_dim),
        depth=overrides.pop("depth", spec.depth),
        num_heads=overrides.pop("num_heads", spec.num_heads),
        mlp_ratio=overrides.pop("mlp_ratio", spec.mlp_ratio),
        num_classes=num_classes,
        drop_path_rate=drop_path_rate,
        has_cls_token=True,
        dtype=dtype,
    )
    if overrides:
        raise ValueError(f"unsupported arch_overrides: {sorted(overrides)}")
    model = VisionTransformer(cfg, capture_layers=capture_layers)
    model.init_weights(seed)
    return model.to(dev), cfg
