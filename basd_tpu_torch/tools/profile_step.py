"""Stage-by-stage profile of the BASD train step on the card: the port of
`tools/profile_step.py`.

    python -m basd_tpu_torch.tools.profile_step                  # Table-3
    python -m basd_tpu_torch.tools.profile_step --imagenet       # Table-1
    python -m basd_tpu_torch.tools.profile_step --img 224 --batch 256 --student vit_small_patch16

One line per stage, in the JAX tool's order and with its names: dual_view
(its draws included), mixup_cutmix, teacher forward, student fwd, student
fwd+bwd (CE), selector fwd, full loss fwd+bwd; each the mean of `--n` calls
by CUDA events after warm-up (`tools/timing.py:device_ms`). Gradients are
taken w.r.t. the student's parameters and the selector's log-temperatures
only, as the train step takes them. The models are staged as `bench.py`
stages them (random weights from seeds, raw size img + 2 patch, images from
`default_rng(0)`), with remat on at 224 px unless `--no-remat`, as the
JAX tool. `main(argv, device="cpu")` runs it on the CPU, where no time is
measured.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.losses import basd_loss, extraction_points, init_selector
from basd_tpu_torch.losses.selector import select_and_mix
from basd_tpu_torch.models import create_student, extract_intermediates, load_teacher
from basd_tpu_torch.ops.mixup import mixup_cutmix, sample_mixup
from basd_tpu_torch.ops.preprocess import dual_view, sample_view_draws
from basd_tpu_torch.tools.timing import fmt_ms, stage_ms

TEACHER_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
DATASET_STATS = ((0.5,) * 3, (0.25,) * 3)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--imagenet", action="store_true",
                    help="Table-1 workload: ViT-Small 224px batch 256")
    ap.add_argument("--cross-arch", action="store_true",
                    help="Table-2 workload: ConvNeXt-V2-Tiny teacher -> ViT-Tiny "
                         "student, 224px batch 256")
    ap.add_argument("--img", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--student", default=None)
    ap.add_argument("--teacher", default="dinov2_vitb14")
    ap.add_argument("--n", type=int, default=None, help="timed calls per stage")
    ap.add_argument("--only", default=None,
                    help="comma-separated stage-name substrings to run "
                         "(e.g. 'teacher,student fwd+bwd')")
    ap.add_argument("--no-remat", action="store_true",
                    help="no gradient checkpointing in the student (bench runs "
                         "without it)")
    return ap.parse_args(argv)


def main(argv=None, *, device=None) -> dict:
    """Print one line per stage; returns {stage: ms} (None where no time
    was measured, on the CPU)."""
    args = parse_args(argv)
    dev = resolve_device(device)
    wanted = [s.strip() for s in args.only.split(",")] if args.only else None

    def stage_on(name: str) -> bool:
        return wanted is None or any(w in name for w in wanted)

    teacher_name = args.teacher
    if args.imagenet:
        img_size, batch, num_classes = 224, 256, 1000
        student_name, patch_override, remat, n = "vit_small_patch16", None, True, 8
    elif args.cross_arch:
        img_size, batch, num_classes = 224, 256, 1000
        student_name, patch_override, remat, n = "vit_tiny_patch16", None, True, 8
        if teacher_name == "dinov2_vitb14":
            teacher_name = "convnextv2_tiny"
    else:
        img_size, batch, num_classes = 32, 128, 100
        student_name, patch_override, remat, n = "vit_tiny_patch16", 4, False, 30
    img_size = args.img or img_size
    batch = args.batch or batch
    student_name = args.student or student_name
    n = args.n or n
    remat = remat and not args.no_remat
    bf16 = torch.bfloat16
    results: dict[str, float | None] = {}

    def report(label: str, name: str, fn) -> None:
        results[name] = stage_ms(fn, dev, n)
        print(f"{label} {fmt_ms(results[name])}", flush=True)

    t0 = time.perf_counter()
    teacher = load_teacher(teacher_name, img_size=img_size, dtype=bf16, device=dev)
    print(f"teacher init: {time.perf_counter() - t0:.1f}s", flush=True)
    points = extraction_points(12, 4)
    t0 = time.perf_counter()
    student, cfg = create_student(
        student_name, num_classes=num_classes, drop_path_rate=0.05,
        img_size=img_size,
        arch_overrides={"patch_size": patch_override} if patch_override else None,
        capture_layers=points, dtype=bf16, remat=remat, device=dev,
    )
    print(f"student init: {time.perf_counter() - t0:.1f}s", flush=True)
    selector = init_selector(1, len(points), cfg.embed_dim, teacher.spec.embed_dim,
                             device=dev)

    rng = np.random.default_rng(0)
    raw = img_size + 2 * cfg.patch_size  # bench.py's raw size
    u8 = torch.from_numpy((rng.random((batch, raw, raw, 3)) * 255).astype(np.uint8)).to(dev)
    labels = torch.from_numpy(rng.integers(0, num_classes, batch, dtype=np.int64)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    views = dict(img_size=img_size, crop_ratio=img_size / raw,
                 teacher_stats=TEACHER_STATS, dataset_stats=DATASET_STATS)

    f_view = lambda: dual_view(u8, sample_view_draws(gen, batch), **views)
    if stage_on("dual_view"):
        report("dual_view:       ", "dual_view", f_view)
    clean, aug = f_view()
    if stage_on("mixup_cutmix"):
        report("mixup_cutmix:    ", "mixup_cutmix", lambda: mixup_cutmix(
            aug, labels, sample_mixup(gen), num_classes=num_classes))
    if stage_on("teacher forward"):
        report("teacher forward: ", "teacher forward",
               lambda: extract_intermediates(teacher, clean))
    t_tokens, t_imp = extract_intermediates(teacher, clean)

    def student_fwd():
        with torch.no_grad():
            return student(aug, train=True, generator=gen).logits

    if stage_on("student fwd:"):
        report("student fwd:     ", "student fwd", student_fwd)

    params = list(student.parameters())

    def ce_grad():
        out = student(aug, train=True, generator=gen)
        ce = -torch.log_softmax(out.logits, dim=-1)[torch.arange(batch, device=dev),
                                                     labels].mean()
        return torch.autograd.grad(ce, params)

    if stage_on("student fwd+bwd"):
        report("student fwd+bwd (CE):", "student fwd+bwd (CE)", ce_grad)

    if stage_on("selector fwd"):
        with torch.no_grad():
            tokens = student(aug, train=False).tokens

        def select():
            with torch.no_grad():
                return select_and_mix(selector, tokens, t_tokens, t_imp)[0]

        report("selector fwd:    ", "selector fwd", select)

    onehot = torch.nn.functional.one_hot(labels, num_classes).float()

    # only the trainables (the student's parameters and the selector's
    # log-temperatures) take gradients, as in the train step
    def full_grad():
        out = student(aug, train=True, generator=gen)
        loss, _ = basd_loss(selector, out.logits, onehot, out.tokens, t_tokens, t_imp,
                            label_smoothing=0.01)
        return torch.autograd.grad(loss, [*params, selector.log_temperatures])

    if stage_on("full loss"):
        report("full loss fwd+bwd:", "full loss fwd+bwd", full_grad)
    return results


if __name__ == "__main__":
    main()
