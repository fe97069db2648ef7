"""The BASD train step: the port of `basd_tpu/training/train_step.py`.

One step: both views from one uint8 batch, the frozen teacher's
intermediates, the student forward with capture, `basd_loss` (selector,
Procrustes per extraction point, CE + UW-SO), backward, and the
ScheduleFree update of the student and the selector temperatures. PyTorch
runs eagerly, so the step mutates its state in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from basd_tpu_torch.losses import basd_loss
from basd_tpu_torch.losses.selector import SelectorState
from basd_tpu_torch.models.teacher import Teacher, extract_intermediates
from basd_tpu_torch.models.vit import VisionTransformer
from basd_tpu_torch.ops.preprocess import dual_view_eval
from basd_tpu_torch.training.schedule_free import ScheduleFreeAdamW


@dataclass
class TrainState:
    student: VisionTransformer  # parameters are the y-point
    selector: SelectorState  # log_temperatures trained; projections frozen
    optimizer: ScheduleFreeAdamW  # over (student, log_temperatures)
    generator: torch.Generator  # drop-path randomness
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
    of them) and the selector's log-temperatures; drop-path generator on
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
    augment: bool = True,
):
    """Build (init_fn, step_fn). init_fn(seed, selector) -> TrainState;
    step_fn(state, images_u8 (B, H, W, 3) uint8, labels (B,)) -> (state,
    metrics), updating `state` in place. `augment=False` is the
    deterministic mode: both views are the eval transform and the targets
    one-hot."""
    if augment:
        raise NotImplementedError(
            "augment=True (TrivialAugmentWide, the warp kernel and "
            "mixup/cutmix) comes with the next port slice (ROADMAP K4 + M5); "
            "pass augment=False"
        )

    def init_fn(seed: int, selector: SelectorState) -> TrainState:
        return init_train_state(
            seed, student, selector, learning_rate=learning_rate,
            weight_decay=weight_decay, warmup_steps=warmup_steps,
        )

    def step_fn(state: TrainState, images_u8: torch.Tensor, labels: torch.Tensor):
        # the named ranges show each stage in a torch.profiler trace
        with record_function("basd:views_teacher"):
            clean, student_imgs = dual_view_eval(
                images_u8,
                img_size=img_size,
                crop_ratio=crop_ratio,
                teacher_stats=teacher_stats,
                dataset_stats=dataset_stats,
            )
            soft_targets = F.one_hot(labels.long(), num_classes).float()
            teacher_tokens, teacher_importance = extract_intermediates(
                teacher, clean)
        with record_function("basd:student_forward"):
            out = state.student(student_imgs, train=True,
                                generator=state.generator)
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
            )
        with record_function("basd:backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        with record_function("basd:optimizer"):
            state.optimizer.step()
        state.step += 1

        # train accuracy against the original labels
        acc = (out.logits.argmax(dim=-1) == labels).float().mean()
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
