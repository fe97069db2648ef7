"""Train entry point: the full BASD pipeline; the port of `basd_tpu/train.py`.

    python -m basd_tpu_torch.train experiment=basd_cifar100 training.num_epochs=10

Stages, in order: teacher -> intrinsic-dimension calibration and the
teacher-derived student architecture (when `model.arch_overrides` is
empty) -> the student with its extraction points -> data arrays and
channel stats -> `subspace_k: auto` calibration -> trainer -> config
snapshot -> optional resume -> train -> final eval suite -> metrics.json.

Runs on one CUDA card by default; `main(argv, device="cpu")` runs the
plain torch path on the CPU. `hardware.precision` picks the compute dtype
and `hardware.remat` recomputes the student's blocks in the backward. The
port has no multi-device path yet: a mesh other than one device raises.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import torch

from basd_tpu_torch.config import compose_config, save_config
from basd_tpu_torch.data.datasets import (
    dataset_info,
    get_channel_stats,
    load_split_arrays,
)
from basd_tpu_torch.data.pipeline import to_device
from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.evaluation.metrics import run_eval_suite, save_metrics
from basd_tpu_torch.losses import calibrate_subspace_k, extraction_points
from basd_tpu_torch.models import (
    create_student,
    derive_student_arch,
    estimate_intrinsic_dim,
    load_teacher,
    resolve_preset,
)
from basd_tpu_torch.ops.preprocess import eval_view
from basd_tpu_torch.training.trainer import Trainer


def compute_dtype(config) -> torch.dtype:
    return torch.bfloat16 if config.hardware.precision == "bfloat16" else torch.float32


def check_single_device(config) -> None:
    """The port runs on one device: a mesh that asks for more raises
    (data and tensor parallelism are not ported yet)."""
    mesh = config.hardware.mesh
    if mesh.model != 1 or mesh.data not in (-1, 1):
        raise ValueError(
            f"hardware.mesh {dict(mesh)}: basd_tpu_torch runs on one device "
            "(data -1 or 1, model 1); data and tensor parallelism are M8 in "
            "ROADMAP.md, not ported yet"
        )


def run(config, *, device=None) -> tuple[dict, Trainer]:
    """Train and evaluate as `config` says; returns (the metrics.json
    results, the trainer)."""
    check_single_device(config)
    dev = resolve_device(device)
    output_dir = Path(config.run.output_dir) / config.run.name
    output_dir.mkdir(parents=True, exist_ok=True)

    img_size = config.model.vit.img_size
    dtype = compute_dtype(config)

    teacher = load_teacher(
        config.basd.teacher_model_name, img_size=img_size,
        seed=config.run.seed, dtype=dtype, device=dev,
    )

    # ---- intrinsic-dim calibration + derived student architecture ----
    arch_overrides = dict(config.model.arch_overrides or {})
    if teacher.spec.feature_format == "token" and not arch_overrides:
        tokens_per_image = (img_size // config.model.vit.patch_size) ** 2
        num_calib = math.ceil(10 * teacher.spec.embed_dim / tokens_per_image)
        calib_u8, _ = load_split_arrays(
            config.data.dataset,
            dataset_info(config.data.dataset)["train_split"],
            img_size,
        )
        num_calib = min(num_calib, len(calib_u8))
        (calib_t,) = to_device((calib_u8[:num_calib],), dev)
        calib = eval_view(calib_t, img_size, config.data.eval_crop_ratio,
                          teacher.mean, teacher.std)
        intrinsic_dim = estimate_intrinsic_dim(teacher, calib)
        arch_overrides = derive_student_arch(teacher.spec, intrinsic_dim)
        print(
            f"student_arch_derived intrinsic_dim={intrinsic_dim} "
            f"embed_dim={arch_overrides['embed_dim']} "
            f"depth={arch_overrides['depth']} "
            f"num_heads={arch_overrides['num_heads']} "
            f"mlp_ratio={arch_overrides['mlp_ratio']:.1f}"
        )
        config.model.arch_overrides = dict(arch_overrides)

    depth = arch_overrides.get("depth") or resolve_preset(
        config.model.student_preset).depth
    points = extraction_points(depth, config.basd.num_extraction_points)

    student, student_cfg = create_student(
        config.model.student_preset,
        num_classes=config.model.num_classes,
        drop_path_rate=config.model.drop_path_rate,
        img_size=img_size,
        arch_overrides={**arch_overrides,
                        "patch_size": config.model.vit.patch_size},
        capture_layers=points,
        dtype=dtype,
        remat=config.hardware.remat,
        device=dev,
        seed=config.run.seed,
    )
    print(
        f"student_created embed_dim={student_cfg.embed_dim} "
        f"depth={student_cfg.depth} num_heads={student_cfg.num_heads} "
        f"num_tokens={student_cfg.num_patches} "
        f"extraction_points={list(points)}"
    )

    # ---- data ----
    info = dataset_info(config.data.dataset)
    train_images, train_labels = load_split_arrays(
        config.data.dataset, info["train_split"], img_size
    )
    val_images, val_labels = load_split_arrays(
        config.data.dataset, info["eval_split"], img_size
    )
    dataset_stats = get_channel_stats(config.data.dataset)

    # ---- subspace-K calibration (basd.subspace_k: auto): the teacher's MP
    # ranks measured once, the static K-cap sized with headroom ----
    if config.basd.get("subspace_k") == "auto":
        calib_n = min(config.data.batch_size, len(train_images))
        (calib_t,) = to_device((train_images[:calib_n],), dev)
        calib = eval_view(calib_t, img_size, config.data.eval_crop_ratio,
                          teacher.mean, teacher.std)
        config.basd.subspace_k = calibrate_subspace_k(
            teacher,
            student_cfg.embed_dim,
            calib,
            seed=config.run.seed,
            num_extraction_points=config.basd.num_extraction_points,
        )

    trainer = Trainer(
        config,
        student=student,
        student_cfg=student_cfg,
        teacher=teacher,
        teacher_stats=(teacher.mean, teacher.std),
        dataset_stats=dataset_stats,
    )

    save_config(config, output_dir / "config.yaml")

    start_epoch = 0
    if config.checkpoint.resume_from:
        start_epoch = trainer.load_checkpoint(config.checkpoint.resume_from)

    trainer.train(
        (train_images, train_labels), (val_images, val_labels),
        start_epoch=start_epoch,
    )

    results = run_eval_suite(
        student,
        trainer.eval_model_params(),
        config,
        config_path=str(output_dir / "config.yaml"),
    )
    save_metrics(results, output_dir)
    return results, trainer


def main(argv: list[str] | None = None, *, device=None) -> tuple[dict, Trainer]:
    """The CLI: `argv` (default `sys.argv[1:]`) are the config overrides."""
    config = compose_config(sys.argv[1:] if argv is None else argv)
    return run(config, device=device)


if __name__ == "__main__":
    main()
