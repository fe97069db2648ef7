"""The train step against ablated step bodies, in context: the port of
`tools/probe_step_gap.py`.

    python -m basd_tpu_torch.tools.probe_step_gap [--teacher dinov2_vitl14]

Four train steps at Table-1's shapes (ViT-S/16 student at 224 px, batch
256; the ViT-B/14 teacher by default, as the JAX probe), each timed as
`bench.py` times a step, the slope (t(n2) - t(n1)) / (n2 - n1) after
`warmup` (5) steps with every run ending in a read of the loss:

  ce_only     the step with CE alone: no teacher and no selector
  ce_teacher  CE, with the teacher's forward run
  ce_sel      CE, with the teacher and the selector's forward and backward
              run, Procrustes left out
  full        the production step (`make_train_step`, bench's step)

The differences are the stages' costs inside the step: the teacher's
forward, the selector's forward and backward, and Procrustes. The ablated
bodies are the production step's (`training/train_step.py`: the same
draws from the state's generator, views, mixup, student and ScheduleFree
update) but for the loss. The port needs no epsilon-coupling, which the
JAX probe uses to keep XLA from eliminating the teacher and the selector:
eager PyTorch runs every op it is given. The selector's backward runs
because its outputs go into the backward with zero cotangents; the
log-temperatures enter the loss times 0, so the optimizer updates the
same parameter list in every variant. Each variant starts from a fresh
student (seed 0) and selector (seed 1). `main(argv, device="cpu",
**SMOKE)` runs the JAX probe's smoke shapes on the CPU.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.losses import calibrate_subspace_k, extraction_points, init_selector
from basd_tpu_torch.losses.selector import select_and_mix
from basd_tpu_torch.models import create_student, extract_intermediates, load_teacher
from basd_tpu_torch.ops.mixup import mixup_cutmix
from basd_tpu_torch.ops.preprocess import dual_view, eval_view
from basd_tpu_torch.tools import DATASET_STATS, TEACHER_STATS
from basd_tpu_torch.training.train_step import make_train_step, sample_step_draws
from basd_tpu_torch.utils.kernel_smoke import validate_kernel_dispatches

HPARAMS = dict(learning_rate=5e-4, weight_decay=0.05, warmup_steps=1000)
# the JAX probe's BASD_PROBE_SMOKE shapes and step counts
SMOKE = dict(img_size=56, batch=8, num_classes=16, n1=1, n2=3)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--teacher", default="dinov2_vitb14")
    return ap.parse_args(argv)


def ablated_step(teacher, num_classes: int, views: dict, subspace_k: int, *,
                 with_teacher: bool, with_selector: bool = False):
    """A step body of `make_train_step(augment=True)` with CE as its loss,
    the teacher's forward and the selector run or left out."""

    def step_fn(state, images_u8, labels):
        draws = sample_step_draws(state.generator, images_u8.shape[0])
        clean, augmented = dual_view(images_u8, draws.view, **views)
        student_imgs, soft_targets = mixup_cutmix(augmented, labels, draws.mix,
                                                  num_classes=num_classes)
        if with_teacher:
            t_tok, t_imp = extract_intermediates(teacher, clean)
        out = state.student(student_imgs, train=True, generator=state.generator)
        logp = torch.log_softmax(out.logits.float(), dim=-1)
        log_temps = state.selector.log_temperatures
        loss = -(soft_targets * logp).sum(-1).mean() + 0.0 * log_temps.sum()
        outputs, cotangents = [loss], [None]
        if with_selector:
            mixed_t, mixed_i, _ = select_and_mix(state.selector, out.tokens, t_tok, t_imp,
                                                 subspace_k=subspace_k)
            outputs += [mixed_t, mixed_i]
            cotangents += [torch.zeros_like(mixed_t), torch.zeros_like(mixed_i)]
        state.optimizer.zero_grad(set_to_none=True)
        torch.autograd.backward(outputs, cotangents)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return step_fn


def main(argv=None, *, device=None, img_size: int = 224, batch: int = 256,
         num_classes: int = 1000, n1: int = 4, n2: int = 24, warmup: int = 5) -> dict:
    """Print each variant's step ms and the in-context deltas; returns
    {variant: ms}."""
    args = parse_args(argv)
    dev = resolve_device(device)
    validate_kernel_dispatches(dev, verbose=False)
    bf16 = torch.bfloat16
    teacher = load_teacher(args.teacher, img_size=img_size, dtype=bf16, device=dev)
    points = extraction_points(12, 4)

    def fresh():
        student, cfg = create_student(
            "vit_small_patch16", num_classes=num_classes, drop_path_rate=0.05,
            img_size=img_size, capture_layers=points, dtype=bf16, remat=False,
            device=dev)
        return student, cfg, init_selector(1, len(points), cfg.embed_dim,
                                           teacher.spec.embed_dim, device=dev)

    student, cfg, selector = fresh()
    rng = np.random.default_rng(0)
    raw = img_size + 2 * cfg.patch_size
    images = torch.from_numpy((rng.random((batch, raw, raw, 3)) * 255).astype(np.uint8)).to(dev)
    labels = torch.from_numpy(rng.integers(0, num_classes, batch, dtype=np.int64)).to(dev)
    views = dict(img_size=img_size, crop_ratio=img_size / raw,
                 teacher_stats=TEACHER_STATS, dataset_stats=DATASET_STATS)
    calib = eval_view(images, img_size, img_size / raw, *TEACHER_STATS)
    subspace_k = calibrate_subspace_k(teacher, cfg.embed_dim, calib, seed=0,
                                      num_extraction_points=len(points))
    del calib

    def slope(label: str, build_step) -> float:
        student, _, selector = fresh()
        init_fn, step_fn = build_step(student)
        state = init_fn(0, selector)

        def run(iters: int) -> tuple[float, float]:
            start = time.perf_counter()
            metrics = None
            for _ in range(iters):
                _, metrics = step_fn(state, images, labels)
            return time.perf_counter() - start, float(metrics["loss"])

        run(warmup)
        t1, _ = run(n1)
        t2, loss = run(n2)
        ms = (t2 - t1) / (n2 - n1) * 1e3
        print(f"[{label}] {ms:8.3f} ms/step (loss {loss:.4f})", flush=True)
        return ms

    def production(student):
        return make_train_step(
            student, teacher, **HPARAMS, label_smoothing=0.01, img_size=img_size,
            crop_ratio=img_size / raw, teacher_stats=TEACHER_STATS,
            dataset_stats=DATASET_STATS, num_classes=num_classes,
            subspace_k=subspace_k, augment=True)

    def ablation(**kw):
        def build(student):
            init_fn, _ = production(student)
            return init_fn, ablated_step(teacher, num_classes, views, subspace_k, **kw)
        return build

    ms = {
        "ce_only": slope("ce_only", ablation(with_teacher=False)),
        "ce_teacher": slope("ce_teacher", ablation(with_teacher=True)),
        "ce_sel": slope("ce_sel", ablation(with_teacher=True, with_selector=True)),
        "full": slope("full", production),
    }
    print(f"in-context teacher fwd: {ms['ce_teacher'] - ms['ce_only']:8.3f} ms", flush=True)
    print(f"in-context selector f+b:{ms['ce_sel'] - ms['ce_teacher']:8.3f} ms", flush=True)
    print(f"in-context procrustes:  {ms['full'] - ms['ce_sel']:8.3f} ms", flush=True)
    print(f"ce_only residual:       {ms['ce_only']:8.3f} ms", flush=True)
    return ms


if __name__ == "__main__":
    main()
