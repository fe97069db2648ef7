"""Epoch loop: shuffled uint8 batches -> the train step -> metrics ->
best/latest checkpoints; the port of `basd_tpu/training/trainer.py`.

The step mutates its state in place (no jit, no donation); on the card it
is one CUDA graph per update where `train_step.step_route` allows (the
default configuration, remat on, included), replayed on the current
stream, so the step clock's events and a save's copies to the host follow
the replay before them. The per-step metrics stay on the device and are
fetched once per epoch; only the mid-epoch save reads values back. Evaluation runs at the ScheduleFree
x-point through `torch.func.functional_call`, so the training parameters
(the y-point) are never touched. Step times come from CUDA events
recorded after each step (no host sync; on the CPU, the host clock).

Before anything is built, the trainer runs the kernels' start-up check
(`utils/kernel_smoke.py`) on its device; a failing kernel raises.

Over a mesh (`parallel/mesh.py`, the JAX trainer's `mesh`) each rank
trains on its slice of the same global batch order, with the student's
tensor-parallel shards where the mesh has a model axis; the step's metrics
are global, so every rank takes the same decisions; rank 0 prints and
writes the checkpoints, which hold the one-process state.
"""

from __future__ import annotations

import hashlib
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
from basd_tpu_torch.parallel.mesh import main_print
from basd_tpu_torch.parallel.sharding_rules import gather_state_dict, shard_module
from basd_tpu_torch.training.train_step import make_train_step
from basd_tpu_torch.utils.kernel_smoke import validate_kernel_dispatches


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


def state_digest(state) -> str:
    """sha256 of a `TrainState`'s bytes: the student's state dict, each
    optimizer slot's z and v, the optimizer's step and weight sum, the
    log-temperatures, the generator's state and the step. Equal digests
    mean bit-identical states."""
    h = hashlib.sha256()

    def add(t: torch.Tensor) -> None:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())

    for t in state.student.state_dict().values():
        add(t)
    group = state.optimizer.param_groups[0]
    for p in group["params"]:
        add(state.optimizer.state[p]["z"])
        add(state.optimizer.state[p]["exp_avg_sq"])
    h.update(repr((group["step"], group["weight_sum"])).encode())
    add(state.selector.log_temperatures)
    add(state.generator.get_state())
    h.update(str(state.step).encode())
    return h.hexdigest()


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
        mesh=None,
    ):
        """The student is trained on its own device (where `create_student`
        put it); the selector is drawn from `run.seed + 1`, the step's
        generator seeded with `run.seed`. Over a `mesh` with a model axis
        the full `student` is replaced by this rank's tensor-parallel
        twin (`self.state.student`)."""
        self.config = config
        self.mesh = mesh
        self._say = main_print(mesh)
        student = shard_module(student, mesh)
        self.student = student
        self.teacher = teacher
        self.device = next(student.parameters()).device

        # the kernels' start-up check (once per process and card; nothing
        # on the CPU): a kernel that does not build, launch or agree with
        # its plain version raises here, before the selector and the step
        t0 = time.perf_counter()
        self.kernel_check_launches = validate_kernel_dispatches(
            self.device, verbose=False)
        self.kernel_check_s = time.perf_counter() - t0
        if any(self.kernel_check_launches.values()):
            self._say(f"kernel_check ok on {self.device}: launches "
                      f"{self.kernel_check_launches} in {self.kernel_check_s:.2f} s")

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
            mesh=mesh,
        )
        self.state = init_fn(config.run.seed, selector)
        # the step's span recorder, which also times the input path
        self.spans = self._step.spans

        ckpt_dir = Path(config.run.output_dir) / config.run.name / "checkpoints"
        self.checkpoints = CheckpointManager(ckpt_dir, mesh=mesh)

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
        shard = None if self.mesh is None else (self.mesh.data_index, self.mesh.data)
        clock = _StepClock(self.device)
        clock.mark()
        for imgs, labs in prefetch_to_device(
            itertools.islice(
                epoch_batches(images, labels, batch_size, rng, shard=shard),
                start_batch, None,
            ),
            device=self.device,
            spans=self.spans,
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
            mesh=self.mesh,
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
        params = self.eval_model_params()
        if self.mesh is not None and self.mesh.model > 1:
            params = gather_state_dict(params, self.mesh,
                                       self.state.student.config.num_heads)
        self.checkpoints.save_weights(filename, params, epoch)

    def load_checkpoint(self, checkpoint_path: str) -> int:
        """Restore the full training state; returns the epoch to resume at.
        A step-granular checkpoint (saved mid-epoch by `save_every_steps`)
        resumes the SAME epoch at the recorded batch offset. The restore
        replaces the optimizer's z and exp_avg_sq tensors, which a captured
        step writes, so the step forgets its capture: the next step warms up
        and captures again."""
        self.state, custom = self.checkpoints.restore_state(
            checkpoint_path, self.state
        )
        self._step.forget()
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

            self._say(
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
        self._say(f"training complete best_val_acc={self.best_val_acc:.4f}")
        return dict(self.metrics_history)
