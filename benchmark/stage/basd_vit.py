"""The port's BASD train step staged as its `Trainer` stages it, for a
configuration with a ViT teacher and a ViT student.

The kernels' start-up check, the student and the frozen teacher built from
the port's modules around the harness's seeded weights, the selector from
`init_selector`, `make_train_step` (the step takes the route that
`step_route` picks) and `init_fn`. Nothing of the port is changed or
wrapped: `Program.step` is the `TrainStep` call a `Trainer` makes.
"""

from __future__ import annotations

import torch

from basd_tpu_torch.losses import extraction_points, init_selector
from basd_tpu_torch.models.specs import ModelSpec
from basd_tpu_torch.models.teacher import Teacher, build_teacher_module
from basd_tpu_torch.models.vit import VisionTransformer, ViTConfig
from basd_tpu_torch.training.train_step import make_train_step
from basd_tpu_torch.utils.kernel_smoke import validate_kernel_dispatches

from benchmark.weights import make_weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def teacher_spec(t: dict) -> ModelSpec:
    return ModelSpec(name=t["preset"], family="vit", embed_dim=t["embed_dim"],
                     depth=t["depth"], num_heads=t["num_heads"], mlp_ratio=t["mlp_ratio"],
                     has_cls_token=True, feature_format="token", patch_size=t["patch_size"],
                     norm_mean=tuple(t["norm_mean"]), norm_std=tuple(t["norm_std"]),
                     layer_scale_init=t.get("layer_scale_init"))


def _loaded(module: torch.nn.Module, weights: dict) -> torch.nn.Module:
    """`module`, built on the meta device, holding `weights` as its
    parameters (no copy, no initialization of its own)."""
    module.load_state_dict(weights, strict=True, assign=True)
    return module


class Program:
    """The port's step on `device`, from the seeds of one run."""

    def __init__(self, cfg: dict, seeds: dict, device: torch.device):
        s, t, d, tr, basd = (cfg["student"], cfg["teacher"], cfg["data"], cfg["training"],
                             cfg["basd"])
        dtype = DTYPES[cfg["hardware"]["precision"]]
        self.kernel_check = validate_kernel_dispatches(device, verbose=False)
        spec = teacher_spec(t)
        with torch.device("meta"):
            t_module = build_teacher_module(spec, s["img_size"], dtype=dtype)
            points = extraction_points(s["depth"], basd["num_extraction_points"])
            student = VisionTransformer(ViTConfig(
                img_size=s["img_size"], patch_size=s["patch_size"], embed_dim=s["embed_dim"],
                depth=s["depth"], num_heads=s["num_heads"], mlp_ratio=s["mlp_ratio"],
                num_classes=s["num_classes"], drop_path_rate=s["drop_path_rate"],
                has_cls_token=True, dtype=dtype, remat=cfg["hardware"]["remat"]),
                capture_layers=points)
        t_module = _loaded(t_module, make_weights({**t, "img_size": s["img_size"],
                                                   "num_classes": 0},
                                                  seeds["teacher"], device))
        t_module = t_module.eval().requires_grad_(False)
        self.teacher = Teacher(spec=spec, module=t_module, img_size=s["img_size"],
                               num_tokens=spec.num_tokens(s["img_size"]),
                               mean=spec.norm_mean, std=spec.norm_std)
        self.student = _loaded(student, make_weights(s, seeds["student"], device))
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

    def step(self, images_u8: torch.Tensor, labels: torch.Tensor) -> dict:
        self.state, metrics = self.step_fn(self.state, images_u8, labels)
        return metrics

    def eager_step(self, images_u8: torch.Tensor, labels: torch.Tensor) -> dict:
        """One step op by op (`TrainStep.eager`), on the same state."""
        self.state, metrics = self.step_fn.eager(self.state, images_u8, labels)
        return metrics

    def leaves(self) -> list[tuple[str, torch.Tensor]]:
        """The optimizer's leaves by name, in its order."""
        named = [(n, p) for n, p in self.student.named_parameters()]
        return named + [("selector.log_temperatures", self.state.selector.log_temperatures)]

    def grad_norms(self) -> dict[str, float]:
        """Each leaf's gradient norm as the optimizer holds it after its
        first step: v = (1 - b2) g^2."""
        opt = self.state.optimizer
        b2 = opt.param_groups[0]["beta2"]
        sums = torch.stack([opt.state[p]["exp_avg_sq"].double().sum() for _, p in self.leaves()])
        norms = torch.sqrt(sums / (1.0 - b2)).tolist()
        return {n: v for (n, _), v in zip(self.leaves(), norms)}

    def params(self) -> dict[str, torch.Tensor]:
        return {n: p.detach().to("cpu", torch.float32, copy=True) for n, p in self.leaves()}

    @property
    def route(self) -> tuple[str, str]:
        return self.step_fn.route, self.step_fn.reason
