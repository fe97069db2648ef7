"""Static model metadata: the preset table of `basd_tpu/models/specs.py`,
copied so the port imports nothing of the JAX package. Architecture facts
(width, depth, heads, CLS token, feature format) are declared per preset
instead of probed from a module at run time.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelSpec:
    """Architecture metadata (mirrors the reference probe dict,
    `teacher.py:100-110`)."""

    name: str
    family: str  # "vit" | "resnet" | "convnext"
    embed_dim: int
    depth: int  # number of feature-extraction layers (ViT blocks / CNN stages)
    num_heads: int  # per-layer heads; CNNs report 1 (uniform attention)
    mlp_ratio: float
    has_cls_token: bool
    feature_format: str  # "token" | "nhwc"
    patch_size: int | None = None
    norm_mean: tuple[float, float, float] = (0.485, 0.456, 0.406)
    norm_std: tuple[float, float, float] = (0.229, 0.224, 0.225)
    # LayerScale gamma init (DINOv2 ViTs: 1e-5); None = plain ViT
    layer_scale_init: float | None = None
    # a ViT block's MLP: "gelu" (fc2(gelu(fc1 x))) or "swiglu" (DINOv2's
    # ViT-g: fc1's packed output a | b, fc2(silu(a) * b))
    ffn: str = "gelu"
    # a ViT's positions: "learned" (a pos_embed table added to the tokens)
    # or "rope" (DINOv3: axial 2-D rotary positions on the patch rows' q
    # and k, no table)
    positions: str = "learned"
    # register tokens after the CLS token (DINOv3: 4); never captured
    num_register_tokens: int = 0
    # every LayerNorm's eps (DINOv2 1e-6, DINOv3 1e-5)
    ln_eps: float = 1e-6

    def num_tokens(self, img_size: int) -> int:
        """Patch tokens (CLS excluded), reference `teacher.py:94`."""
        if self.family == "vit":
            return (img_size // self.patch_size) ** 2
        # CNNs: final stage stride 32 (resnet/convnext alike)
        return max(img_size // 32, 1) ** 2

    def heads_per_layer(self) -> list[int]:
        return [self.num_heads] * self.depth if self.feature_format == "token" else [1]


_VIT_PRESETS: dict[str, dict] = {
    # DeiT-style students (reference student_preset deit_*_patch16_224)
    "vit_tiny_patch16": dict(embed_dim=192, depth=12, num_heads=3, patch_size=16),
    "vit_small_patch16": dict(embed_dim=384, depth=12, num_heads=6, patch_size=16),
    "vit_base_patch16": dict(embed_dim=768, depth=12, num_heads=12, patch_size=16),
    "vit_large_patch16": dict(embed_dim=1024, depth=24, num_heads=16, patch_size=16),
    # DINOv2-style teachers (patch-14 grids; reference teacher_model_name).
    # Real DINOv2 ViTs carry LayerScale with gamma init 1e-5 — modeling
    # them as plain ViTs made real checkpoints convert into wrong teachers
    # (round-2 VERDICT missing #1).
    "dinov2_vits14": dict(
        embed_dim=384, depth=12, num_heads=6, patch_size=14,
        layer_scale_init=1e-5,
    ),
    "dinov2_vitb14": dict(
        embed_dim=768, depth=12, num_heads=12, patch_size=14,
        layer_scale_init=1e-5,
    ),
    "dinov2_vitl14": dict(
        embed_dim=1024, depth=24, num_heads=16, patch_size=14,
        layer_scale_init=1e-5,
    ),
    # DINOv2's largest backbone (`dinov2/hub/backbones.py:dinov2_vitg14`,
    # arch vit_giant2, ffn_layer "swiglufused"; timm's
    # vit_giant_patch14_dinov2): a SwiGLU MLP whose packed fc1 is
    # int(1536 * 5.33334) = 8192 wide, fc2 4096
    "dinov2_vitg14": dict(
        embed_dim=1536, depth=40, num_heads=24, patch_size=14,
        layer_scale_init=1e-5, mlp_ratio=5.33334, ffn="swiglu",
    ),
    # DINOv3's own teacher (`facebookresearch/dinov3` dinov3_vit7b16; the
    # published config facebook/dinov3-vit7b16-pretrain-lvd1689m): width
    # 4096, 40 blocks, 32 heads of 128, patch 16, 4 register tokens after
    # CLS, axial RoPE (base 100) in place of a position table, LayerNorm
    # eps 1e-5, a SwiGLU MLP whose packed fc1 is int(4096 * 4.0) = 16384
    # wide (gate and up 8192 each), fc2 8192; no q/k/v bias (the fused
    # qkv's bias is kept at zero)
    "dinov3_vit7b16": dict(
        embed_dim=4096, depth=40, num_heads=32, patch_size=16,
        layer_scale_init=1e-5, mlp_ratio=4.0, ffn="swiglu", positions="rope",
        num_register_tokens=4, ln_eps=1e-5,
    ),
    # tiny configs for tests / smoke runs
    "vit_micro_patch4": dict(embed_dim=64, depth=4, num_heads=2, patch_size=4),
    "vit_mini_patch4": dict(embed_dim=96, depth=6, num_heads=3, patch_size=4),
    # DINOv2-shaped micro teacher (LayerScale path) for offline tests
    "dinov2_micro_patch4": dict(
        embed_dim=64, depth=4, num_heads=2, patch_size=4,
        layer_scale_init=1e-5,
    ),
    # its SwiGLU twin (packed width int(64 * 5.3125) = 340, g = 170)
    "dinov2_swiglu_micro_patch4": dict(
        embed_dim=64, depth=4, num_heads=2, patch_size=4,
        layer_scale_init=1e-5, mlp_ratio=5.3125, ffn="swiglu",
    ),
    # the DINOv3 ViT-7B's micro twin: 2 heads of 32, RoPE, 4 registers,
    # eps 1e-5, SwiGLU (packed 256, g = 128)
    "dinov3_micro_patch4": dict(
        embed_dim=64, depth=4, num_heads=2, patch_size=4,
        layer_scale_init=1e-5, mlp_ratio=4.0, ffn="swiglu", positions="rope",
        num_register_tokens=4, ln_eps=1e-5,
    ),
}

_CNN_PRESETS: dict[str, dict] = {
    "resnet18": dict(family="resnet", embed_dim=512, depth=4, mlp_ratio=0.0),
    "resnet50": dict(family="resnet", embed_dim=2048, depth=4, mlp_ratio=0.0),
    "convnext_tiny": dict(family="convnext", embed_dim=768, depth=4, mlp_ratio=4.0),
    # ConvNeXt-V2 (GRN MLP, no layer scale) — the reference Table-2
    # cross-architecture teacher is `convnextv2_tiny.fcmae`
    # (`configs/experiment/basd_imagenet_cross_arch.yaml:6`)
    "convnextv2_tiny": dict(family="convnext", embed_dim=768, depth=4, mlp_ratio=4.0),
    "resnet_micro": dict(family="resnet", embed_dim=64, depth=4, mlp_ratio=0.0),
    # 4-stage micro ConvNeXt-V2 (GRN path, stride 32 like the full-size
    # family so ModelSpec.num_tokens holds) — offline cross-arch parity
    # tests (Table-2 semantics: nhwc tokens, no CLS, uniform attention)
    "convnextv2_micro": dict(family="convnext", embed_dim=64, depth=4, mlp_ratio=4.0),
}


def resolve_preset(name: str) -> ModelSpec:
    if name not in _VIT_PRESETS and name not in _CNN_PRESETS and "." in name:
        # timm-style pretrained tag (`convnextv2_tiny.fcmae`): the tag names
        # a weight recipe, not an architecture — strip it
        name = name.split(".", 1)[0]
    if name in _VIT_PRESETS:
        p = _VIT_PRESETS[name]
        return ModelSpec(
            name=name,
            family="vit",
            embed_dim=p["embed_dim"],
            depth=p["depth"],
            num_heads=p["num_heads"],
            mlp_ratio=p.get("mlp_ratio", 4.0),
            has_cls_token=True,
            feature_format="token",
            patch_size=p["patch_size"],
            layer_scale_init=p.get("layer_scale_init"),
            ffn=p.get("ffn", "gelu"),
            positions=p.get("positions", "learned"),
            num_register_tokens=p.get("num_register_tokens", 0),
            ln_eps=p.get("ln_eps", 1e-6),
        )
    if name in _CNN_PRESETS:
        p = _CNN_PRESETS[name]
        return ModelSpec(
            name=name,
            family=p["family"],
            embed_dim=p["embed_dim"],
            depth=p["depth"],
            num_heads=1,
            mlp_ratio=p["mlp_ratio"],
            has_cls_token=False,
            feature_format="nhwc",
        )
    raise KeyError(
        f"unknown model preset '{name}'; available: "
        f"{sorted([*_VIT_PRESETS, *_CNN_PRESETS])}"
    )
