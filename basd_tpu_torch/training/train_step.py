"""The BASD train step: the port of `basd_tpu/training/train_step.py`.

One step: both views from one uint8 batch (RandomResizedCrop, hflip,
TrivialAugmentWide and MixUp/CutMix on the student's view), the frozen
teacher's intermediates, the student forward with capture, `basd_loss`
(selector, Procrustes per extraction point, CE + UW-SO), backward, and the
ScheduleFree update of the student and the selector temperatures. The
step mutates its state in place. Every augmentation draw comes from the
state's generator, on the step's device.

The JAX package compiles the step into one XLA program (remat's
recomputation inside it). Its counterpart here is one CUDA graph, captured
once and replayed (`TrainStep`), on the route `step_route` gives: a CUDA
device, no mesh, and every eigh of the selector on the Jacobi kernel
(cuSOLVER's eigh, which the others take, reads its status back to the
host, and a graph cannot hold that), with or without remat.
Everywhere else the step runs eagerly, op by op, with the same kernels
and the same bits.

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

from basd_tpu_torch.device import CapturedCall
from basd_tpu_torch.losses import basd_loss
from basd_tpu_torch.losses.selector import (
    SelectorState,
    selector_eigh_shapes,
    selector_k,
)
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
from basd_tpu_torch.spectral.ops import use_jacobi
from basd_tpu_torch.training.schedule_free import ScheduleFreeAdamW
from basd_tpu_torch.utils.spans import STEP, SpanRecorder


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


def step_route(
    device,
    *,
    num_points: int,
    teacher_layers: int,
    student_dim: int,
    student_tokens: int,
    teacher_tokens: int,
    batch: int,
    subspace_k: int | None = None,
    mesh=None,
    remat: bool = False,
) -> tuple[str, str]:
    """("graph" | "eager", reason): how a step of this configuration runs.
    "graph" needs a CUDA device, no mesh (its collectives are host calls
    between the stages), and every eigh the selector takes inside the
    Jacobi kernel's gate
    (`spectral.ops.use_jacobi`): the (L, K, K), (P, K, K) and (P, L, K, K)
    eighs at the selector's K for this batch. Outside the gate the eigh is
    cuSOLVER's, which synchronizes with the host. Remat takes either route:
    `torch.utils.checkpoint` (non-reentrant, no RNG state kept) recomputes
    each block inside the backward, on the device alone; the reason says so.
    Token counts exclude the CLS token; `teacher_layers` is 1 for a CNN
    teacher."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "eager", f"{dev.type}: the plain versions, op by op"
    if mesh is not None:
        return "eager", "a mesh: the collectives are host calls between the stages"
    if student_dim < 8:
        return "eager", (f"D_s = {student_dim} < 8: the MP rank takes torch.linalg."
                         "eigvalsh (cuSOLVER), which synchronizes with the host")
    k = selector_k(subspace_k, student_dim, batch * student_tokens,
                   batch * teacher_tokens)
    shapes = selector_eigh_shapes(num_points, teacher_layers, k)
    for shape in shapes:
        if not use_jacobi(shape):
            return "eager", (f"eigh {shape} is outside the Jacobi gate (16 <= n <= 96, "
                             "batch >= 4): torch.linalg.eigh (cuSOLVER), which "
                             "synchronizes with the host")
    recompute = ", remat's recomputation of each student block inside the backward" \
        if remat else ""
    return "graph", f"one CUDA graph: no mesh, the eighs {shapes} on K3{recompute}"


class TrainStep:
    """The step that `make_train_step` returns: `step(state, images_u8,
    labels) -> (state, metrics)`.

    Its first call takes the route from `step_route` (the configuration
    and that call's batch), prints it and keeps it in `route` and `reason`.
    On "eager" every call is `eager`: the optimizer's host half
    (`ScheduleFreeAdamW.advance`), `body`, and `state.step += 1`. On
    "graph" every call copies the batch into static input buffers, runs the
    optimizer's host half, runs `body` on those buffers as a
    `device.CapturedCall` (call 1 the eager warm-up on a side stream, call
    2 the capture, with `state.generator` registered, and its replay, later
    calls replays), advances `state.step` and returns clones of the
    metrics. Under remat the recomputation of the student's blocks runs
    inside the backward, so inside the capture. Nothing falls back to
    eager: a failed capture or replay raises, and so does a batch of
    another shape, dtype or device, another state, or optimizer slots
    that were replaced (a restore) after the warm-up.

    `forget()` drops the route, the capture and its buffers, so that the
    next call routes, warms up and captures again: `Trainer.load_checkpoint`
    calls it, since `optimizer.load_state_dict` replaces the z and
    exp_avg_sq tensors that the graph writes. `graph`, `launches`,
    `capture_s` and `pool_bytes` are the `CapturedCall`'s.

    `spans` is the step's `utils.spans.SpanRecorder` (a CPU one when none
    is given): `body` stamps its stages there, and a call's host work is
    its `basd_host:launch` span."""

    def __init__(self, body, route_for, spans: SpanRecorder | None = None):
        self.body = body
        self._route_for = route_for
        self.spans = SpanRecorder("cpu") if spans is None else spans
        self.forget()

    def forget(self) -> None:
        self.route = self.reason = None
        self._call = self._state = self._inputs = self._slots = None

    @property
    def graph(self):
        return None if self._call is None else self._call.graph

    @property
    def launches(self):
        return None if self._call is None else self._call.launches

    @property
    def capture_s(self):
        return None if self._call is None else self._call.capture_s

    @property
    def pool_bytes(self):
        return None if self._call is None else self._call.pool_bytes

    def eager(self, state: TrainState, images_u8: torch.Tensor, labels: torch.Tensor):
        """One step op by op, on the current stream (either route)."""
        state.optimizer.advance()
        metrics = self.body(state, images_u8, labels)
        state.step += 1
        return state, metrics

    def __call__(self, state: TrainState, images_u8: torch.Tensor, labels: torch.Tensor):
        if self.route is None:
            self.route, self.reason = self._route_for(images_u8.shape[0])
            print(f"train_step route={self.route}: {self.reason}", flush=True)
        with self.spans.launch_span():
            if self.route == "eager":
                return self.eager(state, images_u8, labels)
            if self._state is None:
                self._state = state
                self._inputs = (torch.empty_like(images_u8), torch.empty_like(labels))
                self._slots = _optimizer_slots(state.optimizer)
                self._call = CapturedCall(lambda: self.body(state, *self._inputs),
                                          images_u8.device, state.generator)
            else:
                self._check(state, images_u8, labels)
            self._inputs[0].copy_(images_u8)
            self._inputs[1].copy_(labels)
            state.optimizer.advance()
            metrics = self._call()
            state.step += 1
            return state, {k: v.clone() for k, v in metrics.items()}

    def _check(self, state, images_u8, labels) -> None:
        if state is not self._state:
            raise ValueError("this step's CUDA graph was captured for another TrainState")
        for x, buf in zip((images_u8, labels), self._inputs):
            if (x.shape, x.dtype, x.device) != (buf.shape, buf.dtype, buf.device):
                raise ValueError(
                    f"this step's CUDA graph takes {tuple(buf.shape)} {buf.dtype} on "
                    f"{buf.device}, got {tuple(x.shape)} {x.dtype} on {x.device}")
        slots = _optimizer_slots(state.optimizer)
        if len(slots) != len(self._slots) or any(
                a is not b for a, b in zip(slots, self._slots)):
            raise ValueError("the optimizer's z or exp_avg_sq tensors were replaced after "
                             "this step's warm-up (a restore?): call forget() first")


def _optimizer_slots(optimizer: ScheduleFreeAdamW) -> list[torch.Tensor]:
    """The optimizer's z and exp_avg_sq tensors, in order: what a captured
    step writes besides the parameters."""
    return [optimizer.state[p][key] for group in optimizer.param_groups
            for p in group["params"] for key in ("z", "exp_avg_sq")]


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
    metrics), updating `state` in place: a `TrainStep`, one CUDA graph
    replayed per step where `step_route` allows, else eager. `step_fn.body`
    is the step without the optimizer's host bookkeeping and the step count;
    `step_fn.eager` the whole step op by op; `step_fn.spans` the step's
    `utils.spans.SpanRecorder` on the student's device (off until
    `step_fn.spans.on()`). `augment=True` is bench.py's
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
    spans = SpanRecorder(next(student.parameters()).device)

    def init_fn(seed: int, selector: SelectorState) -> TrainState:
        return init_train_state(
            seed, student, selector, learning_rate=learning_rate,
            weight_decay=weight_decay, warmup_steps=warmup_steps,
        )

    def body(state: TrainState, images_u8: torch.Tensor, labels: torch.Tensor) -> dict:
        """The step's device work: every operation reads the device, and the
        optimizer's update reads the coefficients its host half filled."""
        with spans.span(STEP):
            return stages(state, images_u8, labels)

    def stages(state: TrainState, images_u8: torch.Tensor, labels: torch.Tensor) -> dict:
        b = images_u8.shape[0]
        # a rank's rows of the global batch: (first row, global batch)
        rows = None if mesh is None else (mesh.data_index * b, mesh.data * b)
        # each stage a span: stamped on the device, and a named range in a
        # torch.profiler trace
        if augment:
            with spans.span("basd:augment"):
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
            with spans.span("basd:views"):
                clean, student_imgs = dual_view_eval(images_u8, **views)
                soft_targets = F.one_hot(labels.long(), num_classes).float()
        with spans.span("basd:teacher"):
            teacher_tokens, teacher_importance = extract_intermediates(
                teacher, clean)
        with spans.span("basd:student_forward"):
            out = state.student(student_imgs, train=True,
                                generator=state.generator, batch_rows=rows)
        with spans.span("basd:loss"):
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
                spans=spans,
            )
        with spans.span("basd:backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if mesh is not None:
                all_reduce_grads(state.optimizer.param_groups[0]["params"], mesh)
        with spans.span("basd:optimizer"):
            state.optimizer.update()

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
        return {k: v.detach() for k, v in metrics.items()}

    def route_for(batch: int) -> tuple[str, str]:
        cfg = student.config
        return step_route(
            next(student.parameters()).device, num_points=len(student.capture_layers),
            teacher_layers=len(teacher.spec.heads_per_layer()),
            student_dim=cfg.embed_dim, student_tokens=cfg.num_patches,
            teacher_tokens=teacher.num_tokens, batch=batch, subspace_k=subspace_k,
            mesh=mesh, remat=cfg.remat)

    return init_fn, TrainStep(body, route_for, spans)
