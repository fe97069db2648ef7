"""The BASD train step: the port of `basd_tpu/training/train_step.py`.

One step: both views from one uint8 batch (RandomResizedCrop, hflip,
TrivialAugmentWide and MixUp/CutMix on the student's view), the frozen
teacher's intermediates, the student forward with capture, `basd_loss`
(selector, Procrustes per extraction point, CE + UW-SO), backward, and the
ScheduleFree update of the student and the selector temperatures. PyTorch
runs eagerly, so the step mutates its state in place. Every augmentation
draw comes from the state's generator, on the step's device.

Over a (data, model) mesh (`parallel/mesh.py`) the step computes the
one-process step on the global batch: every rank draws for the global
batch from the same generator and keeps its rows (so every generator holds
the same state after the step), mixup's roll takes the previous rank's
last sample, the selector's statistics and the loss values are global, and
the trainables' gradients are summed over the data group with one flat
all-reduce before the update.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from basd_tpu_torch.losses import basd_loss
from basd_tpu_torch.losses.selector import SelectorState
from basd_tpu_torch.models.teacher import Teacher, extract_intermediates
from basd_tpu_torch.models.vit import VisionTransformer
from basd_tpu_torch.ops.mixup import (
    MixDraws,
    mixup_cutmix,
    sample_mixup,
    shard_neighbour,
)
from basd_tpu_torch.ops.preprocess import (
    ViewDraws,
    dual_view,
    dual_view_eval,
    sample_view_draws,
)
from basd_tpu_torch.parallel.mesh import all_reduce_grads, data_all_reduce
from basd_tpu_torch.training.schedule_free import ScheduleFreeAdamW


@dataclass
class TrainState:
    student: VisionTransformer  # parameters are the y-point
    selector: SelectorState  # log_temperatures trained; projections frozen
    optimizer: ScheduleFreeAdamW  # over (student, log_temperatures)
    generator: torch.Generator  # augmentation draws and drop path
    step: int = 0


def init_train_state(
    seed: int,
    student: VisionTransformer,
    selector: SelectorState,
    *,
    learning_rate: float,
    weight_decay: float,
    warmup_steps: int,
) -> TrainState:
    """Optimizer over the student's CURRENT weights (its z starts as a copy
    of them) and the selector's log-temperatures; the step's generator on
    the student's device, seeded with `seed`."""
    device = next(student.parameters()).device
    optimizer = ScheduleFreeAdamW(
        [*student.parameters(), selector.log_temperatures],
        learning_rate,
        weight_decay=weight_decay,
        warmup_steps=warmup_steps,
    )
    generator = torch.Generator(device=device).manual_seed(seed)
    return TrainState(student, selector, optimizer, generator)


class StepDraws(NamedTuple):
    """The augmentation draws of one step."""

    view: ViewDraws
    mix: MixDraws


def sample_step_draws(generator: torch.Generator, batch: int) -> StepDraws:
    return StepDraws(sample_view_draws(generator, batch), sample_mixup(generator))


def shard_step_draws(draws: StepDraws, lo: int, size: int) -> StepDraws:
    """Rows [lo, lo + size) of a global batch's draws (the per-batch mixup
    draws are shared)."""
    view = draws.view
    rows = lambda t: t[lo:lo + size]
    return StepDraws(
        ViewDraws(type(view.crop)(*map(rows, view.crop)), rows(view.flip),
                  type(view.augment)(*map(rows, view.augment))),
        draws.mix)


def make_train_step(
    student: VisionTransformer,
    teacher: Teacher,
    *,
    learning_rate: float,
    weight_decay: float,
    warmup_steps: int,
    label_smoothing: float,
    img_size: int,
    crop_ratio: float,
    teacher_stats: tuple,
    dataset_stats: tuple,
    num_classes: int,
    subspace_k: int | None = None,
    mesh=None,
    augment: bool = True,
):
    """Build (init_fn, step_fn). init_fn(seed, selector) -> TrainState;
    step_fn(state, images_u8 (B, H, W, 3) uint8, labels (B,)) -> (state,
    metrics), updating `state` in place. `augment=True` is bench.py's
    step: the augmented student view and mixed soft targets, with the draws
    from `sample_step_draws(state.generator, batch)`. `augment=False` is the
    deterministic mode: both views are the eval transform and the targets
    one-hot.

    Without a `mesh` the step takes the global batch. Over a `mesh` it
    takes this rank's shard (`parallel.mesh.batch_shard`: rows
    data_index * B .. of a global batch of data * B) and `student` is the
    rank's tensor-parallel twin where the mesh has a model axis; the
    metrics are the global batch's."""

    views = dict(img_size=img_size, crop_ratio=crop_ratio,
                 teacher_stats=teacher_stats, dataset_stats=dataset_stats)

    def init_fn(seed: int, selector: SelectorState) -> TrainState:
        return init_train_state(
            seed, student, selector, learning_rate=learning_rate,
            weight_decay=weight_decay, warmup_steps=warmup_steps,
        )

    def step_fn(state: TrainState, images_u8: torch.Tensor, labels: torch.Tensor):
        b = images_u8.shape[0]
        # a rank's rows of the global batch: (first row, global batch)
        rows = None if mesh is None else (mesh.data_index * b, mesh.data * b)
        # the named ranges show each stage in a torch.profiler trace
        if augment:
            with record_function("basd:augment"):
                if rows is None:
                    draws = sample_step_draws(state.generator, b)
                else:
                    draws = shard_step_draws(
                        sample_step_draws(state.generator, rows[1]), rows[0], b)
                clean, augmented = dual_view(images_u8, draws.view, **views)
                neighbour = None if mesh is None else shard_neighbour(
                    augmented, labels, num_classes, mesh)
                student_imgs, soft_targets = mixup_cutmix(
                    augmented, labels, draws.mix, num_classes=num_classes,
                    neighbour=neighbour)
        else:
            with record_function("basd:views"):
                clean, student_imgs = dual_view_eval(images_u8, **views)
                soft_targets = F.one_hot(labels.long(), num_classes).float()
        with record_function("basd:teacher"):
            teacher_tokens, teacher_importance = extract_intermediates(
                teacher, clean)
        with record_function("basd:student_forward"):
            out = state.student(student_imgs, train=True,
                                generator=state.generator, batch_rows=rows)
        with record_function("basd:loss"):
            loss, aux = basd_loss(
                state.selector,
                out.logits,
                soft_targets,
                out.tokens,
                teacher_tokens,
                teacher_importance,
                label_smoothing=label_smoothing,
                subspace_k=subspace_k,
                mesh=mesh,
            )
        with record_function("basd:backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if mesh is not None:
                all_reduce_grads(state.optimizer.param_groups[0]["params"], mesh)
        with record_function("basd:optimizer"):
            state.optimizer.step()
        state.step += 1

        # train accuracy against the original labels
        hits = out.logits.argmax(dim=-1) == labels
        if mesh is None:
            acc = hits.float().mean()
        else:
            acc = data_all_reduce(hits.float().sum(), mesh, "metric_sums") / rows[1]
            loss = aux["loss"]
        metrics = {
            "loss": loss,
            "ce_loss": aux["ce_loss"],
            "geo_loss": aux["geo_loss"],
            "train_acc": acc,
            "mixing_weights": aux["mixing_weights"],
            "temperatures": aux["temperatures"],
            "mp_ranks": aux["mp_ranks"],
        }
        return state, {k: v.detach() for k, v in metrics.items()}

    return init_fn, step_fn
