"""Student construction and its teacher-derived sizing
(`basd_tpu/models/factory.py`)."""

from __future__ import annotations

import torch

from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.models.specs import ModelSpec, resolve_preset
from basd_tpu_torch.models.vit import VisionTransformer, ViTConfig


def derive_student_arch(teacher_spec: ModelSpec, intrinsic_dim: int) -> dict:
    """The student's width from the teacher's intrinsic dimension: head_dim
    inherited from the teacher, embed_dim = intrinsic_dim rounded up to a
    multiple of it and capped at the teacher's width; depth and mlp_ratio
    copied."""
    head_dim = teacher_spec.embed_dim // teacher_spec.heads_per_layer()[0]
    d_s = min(-(-intrinsic_dim // head_dim) * head_dim, teacher_spec.embed_dim)
    return {
        "embed_dim": d_s,
        "depth": teacher_spec.depth,
        "num_heads": d_s // head_dim,
        "mlp_ratio": teacher_spec.mlp_ratio,
    }


def create_student(
    preset: str,
    *,
    num_classes: int,
    drop_path_rate: float,
    img_size: int,
    arch_overrides: dict | None = None,
    capture_layers: tuple[int, ...] = (),
    dtype: torch.dtype = torch.bfloat16,
    remat: bool = True,
    device=None,
    seed: int = 0,
) -> tuple[VisionTransformer, ViTConfig]:
    """Build the student ViT from a preset plus `arch_overrides`, with
    weights drawn from `seed`, on `device` (the CUDA card by default).
    `remat` recomputes each block in the backward (the JAX package's
    default, as its trainer's `hardware.remat`)."""
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
        remat=remat,
    )
    if overrides:
        raise ValueError(f"unsupported arch_overrides: {sorted(overrides)}")
    model = VisionTransformer(cfg, capture_layers=capture_layers)
    model.init_weights(seed)
    return model.to(dev), cfg
