"""Frozen teacher construction, intermediate extraction and intrinsic-dim
calibration (`basd_tpu/models/teacher.py`): ViT teachers and the CNN
teachers (ResNet, ConvNeXt V1/V2) of `models.cnn`. Weights are random,
drawn from a seed, or loaded from a weight file through `models.convert`."""

from __future__ import annotations

from typing import NamedTuple

import torch

from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.models.cnn import ConvNeXt, ConvNeXtConfig, ResNet, ResNetConfig
from basd_tpu_torch.models.specs import ModelSpec, resolve_preset
from basd_tpu_torch.models.vit import VisionTransformer, ViTConfig
from basd_tpu_torch.spectral import marchenko_pastur_rank

TeacherModule = VisionTransformer | ResNet | ConvNeXt


class Teacher(NamedTuple):
    spec: ModelSpec
    module: TeacherModule  # a ViT capturing every layer, or a CNN; frozen
    img_size: int
    num_tokens: int
    mean: tuple[float, float, float]
    std: tuple[float, float, float]


def build_teacher_module(
    spec: ModelSpec, img_size: int, dtype=torch.bfloat16
) -> TeacherModule:
    if spec.family == "vit":
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
            ffn=spec.ffn,
            positions=spec.positions,
            num_register_tokens=spec.num_register_tokens,
            ln_eps=spec.ln_eps,
            dtype=dtype,
        )
        return VisionTransformer(cfg, capture_layers=tuple(range(spec.depth)))
    if spec.family == "resnet":
        stage_sizes = (2, 2, 2, 2) if spec.embed_dim <= 512 else (3, 4, 6, 3)
        return ResNet(ResNetConfig(stage_sizes=stage_sizes,
                                   width=spec.embed_dim // 8, dtype=dtype))
    if spec.family == "convnext":
        use_grn = spec.name.startswith("convnextv2")
        if spec.embed_dim <= 64:  # convnextv2_micro (tests)
            return ConvNeXt(ConvNeXtConfig(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64),
                                           use_grn=use_grn, dtype=dtype))
        return ConvNeXt(ConvNeXtConfig(use_grn=use_grn, dtype=dtype))
    raise ValueError(f"unknown teacher family {spec.family}")


def load_teacher(
    model_name: str,
    img_size: int,
    *,
    seed: int = 0,
    weights_path: str | None = None,
    dtype=torch.bfloat16,
    device=None,
    mean: tuple[float, float, float] | None = None,
    std: tuple[float, float, float] | None = None,
) -> Teacher:
    """Build a frozen teacher on `device` (the CUDA card by default): random
    weights from `seed`, or the weight file `weights_path` loaded strictly
    (`models.convert.load_converted_weights`). Normalization stats: the
    explicit `mean`/`std`, else those recorded with the weight file, else
    the preset's. A CNN's token count is read from one forward of a zero
    image, as the JAX package does."""
    dev = resolve_device(device)
    spec = resolve_preset(model_name)
    module = build_teacher_module(spec, img_size, dtype=dtype)
    module.init_weights(seed)
    if weights_path is not None:
        # imported here: convert imports the selector, which imports this
        from basd_tpu_torch.models.convert import (
            load_checkpoint_stats,
            load_converted_weights,
        )

        load_converted_weights(weights_path, module)
        ckpt_stats = load_checkpoint_stats(weights_path)
        if ckpt_stats is not None:
            mean = ckpt_stats[0] if mean is None else mean
            std = ckpt_stats[1] if std is None else std
    module = module.to(dev).eval().requires_grad_(False)
    if spec.family == "vit":
        num_tokens = spec.num_tokens(img_size)
    else:
        with torch.no_grad():
            dummy = torch.zeros((1, img_size, img_size, 3), device=dev)
            num_tokens = module(dummy).tokens.shape[2]
    mean = tuple(mean if mean is not None else spec.norm_mean)
    std = tuple(std if std is not None else spec.norm_std)
    print(
        f"teacher_loaded model={model_name} embed_dim={spec.embed_dim} "
        f"depth={spec.depth} heads_per_layer={spec.heads_per_layer()} "
        f"mlp_ratio={spec.mlp_ratio:.1f} feature_format={spec.feature_format} "
        f"has_cls={spec.has_cls_token} num_tokens={num_tokens} "
        f"mean={mean} std={std} device={dev}"
    )
    return Teacher(spec=spec, module=module, img_size=img_size,
                   num_tokens=num_tokens, mean=mean, std=std)


@torch.no_grad()
def extract_intermediates(
    teacher: Teacher, x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """All-layer tokens (L, B, N, D) and attention importance (L, B, N),
    without gradient; a CNN gives one layer and uniform importance."""
    out = teacher.module(x, train=False)
    return out.tokens, out.importance


@torch.no_grad()
def estimate_intrinsic_dim(teacher: Teacher, images: torch.Tensor) -> int:
    """Marchenko-Pastur rank of the last layer's tokens on calibration
    images: the teacher's intrinsic dimensionality, which sizes the derived
    student (`models.factory.derive_student_arch`)."""
    tokens, _ = extract_intermediates(teacher, images)
    flat = tokens[-1].reshape(-1, tokens.shape[-1]).float()
    return int(marchenko_pastur_rank(flat))
