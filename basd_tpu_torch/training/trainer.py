"""Epoch loop: shuffled uint8 batches -> the train step -> metrics ->
best/latest checkpoints; the port of `basd_tpu/training/trainer.py`.

The step mutates its state in place (no jit, no donation). The per-step
metrics stay on the device and are fetched once per epoch; only the
mid-epoch save reads values back. Evaluation runs at the ScheduleFree
x-point through `torch.func.functional_call`, so the training parameters
(the y-point) are never touched. Step times come from CUDA events
recorded after each step (no host sync; on the CPU, the host clock).
"""

from __future__ import annotations

import itertools
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from basd_tpu_torch.checkpoint import CheckpointManager
from basd_tpu_torch.data.pipeline import epoch_batches, prefetch_to_device
from basd_tpu_torch.evaluation.metrics import evaluate_model
from basd_tpu_torch.losses import extraction_points, init_selector
from basd_tpu_torch.models.teacher import Teacher
from basd_tpu_torch.models.vit import VisionTransformer, ViTConfig
from basd_tpu_torch.training.train_step import make_train_step


class _StepClock:
    """Times between consecutive step ends: CUDA events on the card (read
    after the epoch's one sync), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list[float]:
        if self.cuda:
            if self.marks:
                self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


class Trainer:
    def __init__(
        self,
        config,
        *,
        student: VisionTransformer,
        student_cfg: ViTConfig,
        teacher: Teacher,
        teacher_stats: tuple,
        dataset_stats: tuple,
    ):
        """The student is trained on its own device (where `create_student`
        put it); the selector is drawn from `run.seed + 1`, the step's
        generator seeded with `run.seed`."""
        self.config = config
        self.student = student
        self.teacher = teacher
        self.device = next(student.parameters()).device

        points = extraction_points(
            student_cfg.depth, config.basd.num_extraction_points
        )
        self.extraction_points = points
        selector = init_selector(
            config.run.seed + 1, len(points), student_cfg.embed_dim,
            teacher.spec.embed_dim, device=self.device,
        )
        init_fn, self._step = make_train_step(
            student,
            teacher,
            learning_rate=config.training.learning_rate,
            weight_decay=config.training.weight_decay,
            warmup_steps=config.training.get("warmup_steps", 0),
            label_smoothing=config.training.label_smoothing,
            img_size=config.model.vit.img_size,
            crop_ratio=config.data.eval_crop_ratio,
            teacher_stats=teacher_stats,
            dataset_stats=dataset_stats,
            num_classes=config.model.num_classes,
            subspace_k=config.basd.get("subspace_k"),
        )
        self.state = init_fn(config.run.seed, selector)

        ckpt_dir = Path(config.run.output_dir) / config.run.name / "checkpoints"
        self.checkpoints = CheckpointManager(ckpt_dir)

        self.best_val_acc = 0.0
        self.metrics_history: dict[str, list] = defaultdict(list)
        self._eval_stats = dataset_stats
        # mid-epoch resume point, set by load_checkpoint from a
        # step-granular checkpoint and consumed by the first train() epoch
        self._resume_batch = 0
        self._resume_sums: dict | None = None
        # ms from the previous step's end (or the epoch's start) to each
        # step's end, over every epoch run
        self.step_ms: list[float] = []

    # ------------------------------------------------------------------

    def _stack_mean(self, values: list) -> float:
        return float(torch.stack([
            torch.as_tensor(v, dtype=torch.float32, device=self.device)
            for v in values
        ]).mean())

    def _train_epoch(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        epoch: int,
        *,
        start_batch: int = 0,
        epoch_sums: dict | None = None,
    ):
        """One epoch; `start_batch`/`epoch_sums` restart mid-epoch after a
        preemption (the batch order is a pure function of (seed, epoch), so
        skipping the first `start_batch` batches replays the identical
        stream). With `checkpoint.save_every_steps` set, `latest` is saved
        asynchronously every N optimizer steps with the running metric
        sums, so a killed job loses at most N steps."""
        batch_size = self.config.data.batch_size
        save_every = self.config.checkpoint.get("save_every_steps")
        rng = np.random.default_rng(self.config.run.seed * 100_003 + epoch)

        losses = list(epoch_sums["losses"]) if epoch_sums else []
        accs = list(epoch_sums["accs"]) if epoch_sums else []
        batch_idx = start_batch
        clock = _StepClock(self.device)
        clock.mark()
        for imgs, labs in prefetch_to_device(
            itertools.islice(
                epoch_batches(images, labels, batch_size, rng), start_batch, None
            ),
            device=self.device,
        ):
            self.state, metrics = self._step(self.state, imgs, labs)
            clock.mark()
            losses.append(metrics["loss"])
            accs.append(metrics["train_acc"])
            batch_idx += 1
            if save_every and batch_idx % save_every == 0:
                self.checkpoints.save_state(
                    "latest",
                    self.state,
                    epoch=epoch,
                    best_val_acc=self.best_val_acc,
                    metrics_history=dict(self.metrics_history),
                    step_in_epoch=batch_idx,
                    epoch_sums={
                        "losses": [float(x) for x in losses],
                        "accs": [float(x) for x in accs],
                    },
                )

        result = {
            "train_loss": self._stack_mean(losses),
            "train_acc": 100.0 * self._stack_mean(accs),
        }
        self.step_ms.extend(clock.intervals_ms())
        return result

    def eval_model_params(self) -> dict[str, torch.Tensor]:
        """The ScheduleFree x-point of the student, by parameter name."""
        names = [n for n, _ in self.state.student.named_parameters()]
        return dict(zip(names, self.state.optimizer.eval_params()))

    def evaluate(self, images: np.ndarray, labels: np.ndarray):
        cfg = self.config
        return evaluate_model(
            self.state.student,
            self.eval_model_params(),
            images,
            labels,
            img_size=cfg.model.vit.img_size,
            crop_ratio=cfg.data.eval_crop_ratio,
            mean=self._eval_stats[0],
            std=self._eval_stats[1],
            batch_size=cfg.data.batch_size,
        )

    # ------------------------------------------------------------------

    def save_checkpoint(self, name: str, epoch: int) -> None:
        self.checkpoints.save_state(
            name,
            self.state,
            epoch=epoch,
            best_val_acc=self.best_val_acc,
            metrics_history=dict(self.metrics_history),
        )

    def save_weights(self, filename: str, epoch: int) -> None:
        self.checkpoints.save_weights(filename, self.eval_model_params(), epoch)

    def load_checkpoint(self, checkpoint_path: str) -> int:
        """Restore the full training state; returns the epoch to resume at.
        A step-granular checkpoint (saved mid-epoch by `save_every_steps`)
        resumes the SAME epoch at the recorded batch offset."""
        self.state, custom = self.checkpoints.restore_state(
            checkpoint_path, self.state
        )
        self.best_val_acc = custom["best_val_acc"]
        self.metrics_history = defaultdict(list, custom["metrics_history"])
        if custom.get("step_in_epoch"):
            self._resume_batch = custom["step_in_epoch"]
            self._resume_sums = custom["epoch_sums"]
            return custom["epoch"]
        return custom["epoch"] + 1

    # ------------------------------------------------------------------

    def train(
        self,
        train_data: tuple[np.ndarray, np.ndarray],
        val_data: tuple[np.ndarray, np.ndarray],
        start_epoch: int = 0,
    ) -> dict[str, list]:
        num_epochs = self.config.training.num_epochs
        train_images, train_labels = train_data
        val_images, val_labels = val_data

        for epoch in range(start_epoch, num_epochs):
            start_batch, sums = self._resume_batch, self._resume_sums
            self._resume_batch, self._resume_sums = 0, None
            train_metrics = self._train_epoch(
                train_images, train_labels, epoch,
                start_batch=start_batch, epoch_sums=sums,
            )
            val_metrics = self.evaluate(val_images, val_labels)

            print(
                f"epoch {epoch + 1}/{num_epochs} "
                f"train_loss={train_metrics['train_loss']:.6f} "
                f"train_acc={train_metrics['train_acc']:.4f} "
                f"val_acc={val_metrics['val_acc']:.4f}"
            )

            for key, value in {**train_metrics, **val_metrics}.items():
                self.metrics_history[key].append(value)

            if val_metrics["val_acc"] > self.best_val_acc:
                self.best_val_acc = val_metrics["val_acc"]
                self.save_checkpoint("best_model", epoch)
                self.save_weights("best_model.npz", epoch)

            self.save_checkpoint("latest", epoch)

        self.save_weights("final_model.npz", num_epochs - 1)
        self.checkpoints.wait()  # drain the async save before returning
        print(f"training complete best_val_acc={self.best_val_acc:.4f}")
        return dict(self.metrics_history)
