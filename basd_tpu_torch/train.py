"""Train entry point: the full BASD pipeline; the port of `basd_tpu/train.py`.

    python -m basd_tpu_torch.train experiment=basd_cifar100 training.num_epochs=10

Stages, in order: teacher -> intrinsic-dimension calibration and the
teacher-derived student architecture (when `model.arch_overrides` is
empty) -> the student with its extraction points -> data arrays and
channel stats -> `subspace_k: auto` calibration -> trainer -> config
snapshot -> optional resume -> train -> final eval suite -> metrics.json.

Runs on one CUDA card by default; `main(argv, device="cpu")` runs the
plain torch path on the CPU. The log says which path each part took: the
step prints `train_step route=graph|eager: <reason>` at its first call
(one CUDA graph per update on the card, remat included, where
`training.train_step.step_route` allows), and the run prints `eval
route=graph|eager: <reason>` (`evaluation.metrics.eval_route`) before it
trains. `hardware.precision` picks the compute dtype
and `hardware.remat` recomputes the student's blocks in the backward.

Launched by torchrun with more than one process, the run is data and
tensor parallel over `hardware.mesh` (`parallel/mesh.py`):

    python -m torch.distributed.run --nproc_per_node=N -m basd_tpu_torch.train \
        experiment=basd_cifar100 hardware.mesh.data=N hardware.mesh.model=1

The intrinsic-dimension and K calibrations run on rank 0 and are
broadcast, rank 0 prints and writes, and each rank ends with one
`rank_summary` line (its K, steps, kernel launches, those of the
trainer's kernel start-up check among them, step ms, peak memory and the
digest of its training state). In one process `hardware.mesh` is
ignored, as the JAX package ignores it on one device.
"""

from __future__ import annotations

import json
import math
import os
import sys
from pathlib import Path

import torch

from basd_tpu_torch import kernels
from basd_tpu_torch.config import compose_config, save_config
from basd_tpu_torch.data.datasets import (
    dataset_info,
    get_channel_stats,
    load_split_arrays,
)
from basd_tpu_torch.data.pipeline import to_device
from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.evaluation.metrics import eval_route, run_eval_suite, save_metrics
from basd_tpu_torch.losses import calibrate_subspace_k, extraction_points
from basd_tpu_torch.models import (
    create_student,
    derive_student_arch,
    estimate_intrinsic_dim,
    load_teacher,
    resolve_preset,
)
from basd_tpu_torch.ops.preprocess import eval_view
from basd_tpu_torch.parallel.mesh import (
    broadcast_int,
    main_print,
    mesh_from_config,
    shutdown,
)
from basd_tpu_torch.training.trainer import Trainer, state_digest


def compute_dtype(config) -> torch.dtype:
    return torch.bfloat16 if config.hardware.precision == "bfloat16" else torch.float32


def run(config, *, device=None) -> tuple[dict, Trainer]:
    """Train and evaluate as `config` says; returns (the metrics.json
    results, the trainer)."""
    dev = resolve_device(device)
    mesh = mesh_from_config(config, dev)
    if mesh is not None:
        dev = mesh.device
    main_rank = mesh is None or mesh.is_main
    say = main_print(mesh)
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
        intrinsic_dim = None
        if main_rank:
            (calib_t,) = to_device((calib_u8[:num_calib],), dev)
            calib = eval_view(calib_t, img_size, config.data.eval_crop_ratio,
                              teacher.mean, teacher.std)
            intrinsic_dim = estimate_intrinsic_dim(teacher, calib)
        intrinsic_dim = broadcast_int(intrinsic_dim, mesh)
        arch_overrides = derive_student_arch(teacher.spec, intrinsic_dim)
        say(
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
    say(
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
        k = None
        if main_rank:
            calib_n = min(config.data.batch_size, len(train_images))
            (calib_t,) = to_device((train_images[:calib_n],), dev)
            calib = eval_view(calib_t, img_size, config.data.eval_crop_ratio,
                              teacher.mean, teacher.std)
            k = calibrate_subspace_k(
                teacher,
                student_cfg.embed_dim,
                calib,
                seed=config.run.seed,
                num_extraction_points=config.basd.num_extraction_points,
            )
        config.basd.subspace_k = broadcast_int(k, mesh)

    trainer = Trainer(
        config,
        student=student,
        student_cfg=student_cfg,
        teacher=teacher,
        teacher_stats=(teacher.mean, teacher.std),
        dataset_stats=dataset_stats,
        mesh=mesh,
    )
    del student  # the trainer's (a tensor-parallel twin over a model axis)
    # the step prints its route at its first call (`train_step route=...`)
    say("eval route={}: {}".format(*eval_route(dev, mesh)))

    if main_rank:
        save_config(config, output_dir / "config.yaml")

    start_epoch = 0
    if config.checkpoint.resume_from:
        start_epoch = trainer.load_checkpoint(config.checkpoint.resume_from)

    trainer.train(
        (train_images, train_labels), (val_images, val_labels),
        start_epoch=start_epoch,
    )

    results = run_eval_suite(
        trainer.state.student,
        trainer.eval_model_params(),
        config,
        config_path=str(output_dir / "config.yaml"),
        mesh=mesh,
    )
    if main_rank:
        save_metrics(results, output_dir)
    if mesh is not None:
        print_rank_summary(trainer, mesh)
    return results, trainer


def print_rank_summary(trainer: Trainer, mesh) -> None:
    """One line per rank: what a launcher checks to see that the ranks
    agree and went through the kernels."""
    dev = mesh.device
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
    line = "rank_summary " + json.dumps({
        "rank": mesh.rank, "data_index": mesh.data_index,
        "model_index": mesh.model_index, "mesh": mesh.shape,
        "backend": mesh.backend, "subspace_k": trainer.config.basd.subspace_k,
        "steps": trainer.state.step, "launches": dict(kernels.LAUNCHES),
        "kernel_check_launches": trainer.kernel_check_launches,
        "kernel_check_s": trainer.kernel_check_s,
        "step_ms": trainer.step_ms, "peak_gib": peak,
        "state_digest": state_digest(trainer.state),
    }) + "\n"
    # one write, so the ranks' lines do not interleave on a shared stdout
    sys.stdout.flush()
    os.write(sys.stdout.fileno(), line.encode())


def main(argv: list[str] | None = None, *, device=None) -> tuple[dict, Trainer]:
    """The CLI: `argv` (default `sys.argv[1:]`) are the config overrides."""
    config = compose_config(sys.argv[1:] if argv is None else argv)
    return run(config, device=device)


if __name__ == "__main__":
    main()
    shutdown()
