"""Eval entry point: checkpoint-only evaluation; the port of
`basd_tpu/evaluate.py`.

    python -m basd_tpu_torch.evaluate config=outputs/basd_cifar100/config.yaml \
        checkpoint.path=outputs/basd_cifar100/checkpoints/best_model.npz

Rebuilds the student from the run snapshot's `model.arch_overrides` (the
train/eval contract: the snapshot carries the teacher-derived
architecture) with drop_path 0 and no remat, loads a weights-only `.npz`
export strictly, and runs the eval suite. Without `config=`, the config is
composed from `experiment=...` and overrides as for training. Runs on the
CUDA card by default; `main(argv, device="cpu")` on the CPU.
"""

from __future__ import annotations

import sys
from pathlib import Path

from basd_tpu_torch.checkpoint import CheckpointManager
from basd_tpu_torch.config import compose_config, compose_from_snapshot, save_config
from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.evaluation.metrics import run_eval_suite, save_metrics
from basd_tpu_torch.models import create_student
from basd_tpu_torch.train import check_single_device, compute_dtype


def run(config, *, device=None) -> dict:
    check_single_device(config)
    dev = resolve_device(device)
    output_dir = Path(config.run.output_dir) / config.run.name
    output_dir.mkdir(parents=True, exist_ok=True)

    arch_overrides = dict(config.model.arch_overrides or {})
    student, _ = create_student(
        config.model.student_preset,
        num_classes=config.model.num_classes,
        drop_path_rate=0.0,
        img_size=config.model.vit.img_size,
        arch_overrides={**arch_overrides,
                        "patch_size": config.model.vit.patch_size},
        dtype=compute_dtype(config),
        remat=False,
        device=dev,
        seed=config.run.seed,
    )

    ckpt_path = Path(config.checkpoint.path)
    params, epoch = CheckpointManager(ckpt_path.parent).load_weights(
        ckpt_path, student.state_dict())
    student.load_state_dict(params, strict=True)
    print(f"checkpoint_loaded path={ckpt_path} epoch={epoch}")

    save_config(config, output_dir / "config.yaml")

    results = run_eval_suite(
        student, None, config, config_path=str(output_dir / "config.yaml"),
    )
    save_metrics(results, output_dir)
    return results


def main(argv: list[str] | None = None, *, device=None) -> dict:
    """The CLI: `config=<run_dir>/config.yaml` evaluates against the run's
    snapshot, remaining dotted overrides (e.g. `checkpoint.path=...`)
    apply on top; without it the config is composed as for training."""
    args = list(sys.argv[1:] if argv is None else argv)
    snapshot = None
    rest = []
    for ov in args:
        if ov.startswith("config="):
            snapshot = ov.partition("=")[2]
        else:
            rest.append(ov)
    if snapshot is not None:
        config = compose_from_snapshot(snapshot, rest)
    else:
        config = compose_config(args)
    return run(config, device=device)


if __name__ == "__main__":
    main()
