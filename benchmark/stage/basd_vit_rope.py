"""The port's BASD train step staged as its `Trainer` stages it, for a
configuration with a RoPE ViT teacher (DINOv3's ViT-7B: axial RoPE,
register tokens, LayerNorm eps 1e-5, a SwiGLU MLP) and a ViT student:
`stage/basd_vit.py`'s staging with the teacher's leaves cut from the seeded
ViT draw by `rope_weights.cut`, the reference's own rule.

The draw holds more than the teacher keeps (fc2's unused half, the position
table), and every drawn leaf is a view of its one buffer: the kept leaves
that are views are copied and the draw let go before the first step, so
the buffer does not stay on the card beside the teacher for the whole run.
"""

from __future__ import annotations

import torch

from basd_tpu_torch.losses import extraction_points, init_selector
from basd_tpu_torch.models.specs import ModelSpec
from basd_tpu_torch.models.teacher import Teacher, build_teacher_module
from basd_tpu_torch.models.vit import VisionTransformer, ViTConfig
from basd_tpu_torch.training.train_step import make_train_step
from basd_tpu_torch.utils.kernel_smoke import validate_kernel_dispatches

from benchmark import rope_weights
from benchmark.stage import basd_vit
from benchmark.weights import make_weights


def teacher_spec(t: dict) -> ModelSpec:
    return ModelSpec(name=t["preset"], family="vit", embed_dim=t["embed_dim"],
                     depth=t["depth"], num_heads=t["num_heads"], mlp_ratio=t["mlp_ratio"],
                     has_cls_token=True, feature_format="token", patch_size=t["patch_size"],
                     norm_mean=tuple(t["norm_mean"]), norm_std=tuple(t["norm_std"]),
                     layer_scale_init=t.get("layer_scale_init"), ffn=t["ffn"],
                     positions=t["positions"], num_register_tokens=t["num_register_tokens"],
                     ln_eps=t["ln_eps"])


def teacher_weights(t: dict, img_size: int, seed: int, device) -> dict[str, torch.Tensor]:
    """The teacher's leaves, each in storage of its own: the cut of the draw,
    its views copied, the draw released."""
    drawn = make_weights({**t, "img_size": img_size, "num_classes": 0}, seed, device)
    kept = rope_weights.cut(drawn, t)
    del drawn
    return {n: w.clone() if w._base is not None else w for n, w in kept.items()}


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
        t_weights = teacher_weights(t, s["img_size"], seeds["teacher"], device)
        if device.type == "cuda":
            torch.cuda.empty_cache()  # the draw's buffer, back to the card
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

    def eager_step(self, images_u8: torch.Tensor, labels: torch.Tensor) -> dict:
        """One step op by op on the same state, after the captured step is
        let go: its graph's pool and an eager step's activations do not fit
        beside the 27 GB teacher together (nothing replays after this)."""
        self.step_fn.forget()
        if images_u8.device.type == "cuda":
            torch.cuda.empty_cache()
        return super().eager_step(images_u8, labels)
