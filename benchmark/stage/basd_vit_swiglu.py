"""The port's BASD train step staged as its `Trainer` stages it, for a
configuration with a SwiGLU ViT teacher (DINOv2's ViT-g) and a ViT
student: `stage/basd_vit.py`'s staging with the teacher built with
`ffn="swiglu"` and its MLP leaves cut from the seeded ViT draw
(`swiglu_weights.cut`, the reference's own rule).
"""

from __future__ import annotations

import torch

from basd_tpu_torch.losses import extraction_points, init_selector
from basd_tpu_torch.models.specs import ModelSpec
from basd_tpu_torch.models.teacher import Teacher, build_teacher_module
from basd_tpu_torch.models.vit import VisionTransformer, ViTConfig
from basd_tpu_torch.training.train_step import make_train_step
from basd_tpu_torch.utils.kernel_smoke import validate_kernel_dispatches

from benchmark import swiglu_weights
from benchmark.stage import basd_vit
from benchmark.weights import make_weights


def teacher_spec(t: dict) -> ModelSpec:
    return ModelSpec(name=t["preset"], family="vit", embed_dim=t["embed_dim"],
                     depth=t["depth"], num_heads=t["num_heads"], mlp_ratio=t["mlp_ratio"],
                     has_cls_token=True, feature_format="token", patch_size=t["patch_size"],
                     norm_mean=tuple(t["norm_mean"]), norm_std=tuple(t["norm_std"]),
                     layer_scale_init=t.get("layer_scale_init"), ffn=t["ffn"])


class Program(basd_vit.Program):
    """The port's step on `device`, from the seeds of one run."""

    def __init__(self, cfg: dict, seeds: dict, device: torch.device):
        s, t, d, tr, basd = (cfg["student"], cfg["teacher"], cfg["data"], cfg["training"],
                             cfg["basd"])
        dtype = basd_vit.DTYPES[cfg["hardware"]["precision"]]
        spec = teacher_spec(t)
        self.kernel_check = validate_kernel_dispatches(device, verbose=False)
        with torch.device("meta"):
            t_module = build_teacher_module(spec, s["img_size"], dtype=dtype)
            points = extraction_points(s["depth"], basd["num_extraction_points"])
            student = VisionTransformer(ViTConfig(
                img_size=s["img_size"], patch_size=s["patch_size"], embed_dim=s["embed_dim"],
                depth=s["depth"], num_heads=s["num_heads"], mlp_ratio=s["mlp_ratio"],
                num_classes=s["num_classes"], drop_path_rate=s["drop_path_rate"],
                has_cls_token=True, dtype=dtype, remat=cfg["hardware"]["remat"]),
                capture_layers=points)
        t_weights = make_weights({**t, "img_size": s["img_size"], "num_classes": 0},
                                 seeds["teacher"], device)
        t_weights = swiglu_weights.cut(t_weights, t["embed_dim"], t["mlp_ratio"])
        t_module = basd_vit._loaded(t_module, t_weights).eval().requires_grad_(False)
        self.teacher = Teacher(spec=spec, module=t_module, img_size=s["img_size"],
                               num_tokens=spec.num_tokens(s["img_size"]),
                               mean=spec.norm_mean, std=spec.norm_std)
        self.student = basd_vit._loaded(student, make_weights(s, seeds["student"], device))
        selector = init_selector(seeds["selector"], len(points), s["embed_dim"],
                                 t["embed_dim"], device=device)
        init_fn, self.step_fn = make_train_step(
            self.student, self.teacher, learning_rate=tr["learning_rate"],
            weight_decay=tr["weight_decay"], warmup_steps=tr["warmup_steps"],
            label_smoothing=tr["label_smoothing"], img_size=s["img_size"],
            crop_ratio=d["crop_ratio"], teacher_stats=(spec.norm_mean, spec.norm_std),
            dataset_stats=tuple(map(tuple, d["dataset_stats"])),
            num_classes=s["num_classes"], subspace_k=basd["subspace_k"], augment=True)
        self.state = init_fn(seeds["step"], selector)
