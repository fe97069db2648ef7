"""Headline benchmark of the port: one full BASD train step on the card,
the port of the JAX package's `bench.py`.

    python -m basd_tpu_torch.bench [--imagenet | --cross-arch] [--teacher NAME] [--batch N]

Prints ONE JSON line, the JAX bench's (`bench.py:320-360`): {"metric",
"value" (images/s on the card), "unit", "vs_baseline": null, "detail"},
where `detail` adds the kernels' launches per timed step (`launches`), the
step's route (`step_route`: "graph" where it is one CUDA graph replayed,
else "eager") and the card's name and power limit (`device`) to the JAX
bench's keys.

The arms are the JAX bench's (`bench.py:147-201`): by default the
reference's Table-3 step (DeiT-Tiny/4 student at 32 px, DINOv2 ViT-B/14
teacher, batch 128), `--imagenet` Table-1 (ViT-S/16 at 224 px, batch 256),
`--cross-arch` Table-2 (ConvNeXt-V2-Tiny teacher, DeiT-Tiny/16 student);
`--teacher` and `--batch` override the teacher preset and the batch and
add their suffixes to the metric. One step is `make_train_step(
augment=True)`: both views with TrivialAugmentWide and MixUp/CutMix, the
frozen teacher, the student, the selector, Procrustes, CE + UW-SO, the
backward and the ScheduleFree update, with random weights from seeds and
images from `default_rng(0)`, staged as `bench.py:211-272` stages them.

Step time is the JAX bench's slope: (t(n2 steps) - t(n1 steps)) / (n2 -
n1) after 5 warm-up steps, each run ending in a read of the loss's value,
which waits for the card. `mfu_vs_bf16_peak` is the step's FLOPs, counted by
`utils.profiling.step_cost_analysis` over one more step (matrix products,
convolutions and the kernels' own reports; no elementwise work and no
cuSOLVER eigh, so the share is conservative), over the step time and the
H100's dense bf16 peak.

It runs on the card unless `main(..., device="cpu")` asks for the CPU
(the plain versions of the kernels; the hidden `--smoke` shrinks every arm
to batch 8 at 32 or 64 px and 1/3 timed steps, a wiring check whose numbers
mean nothing).
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time

import numpy as np
import torch

from basd_tpu_torch import kernels
from basd_tpu_torch.device import card_line, resolve_device
from basd_tpu_torch.losses import calibrate_subspace_k, extraction_points, init_selector
from basd_tpu_torch.models import create_student, load_teacher
from basd_tpu_torch.ops.preprocess import eval_view
from basd_tpu_torch.training.train_step import make_train_step
from basd_tpu_torch.utils.kernel_smoke import validate_kernel_dispatches
from basd_tpu_torch.utils.profiling import step_cost_analysis

# one H100 SXM's dense bf16 tensor-core peak (NVIDIA's data sheet, without
# sparsity, at the 700 W power limit)
H100_BF16_PEAK_FLOPS = 989e12
TEACHER_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
DATASET_STATS = ((0.507, 0.487, 0.441), (0.267, 0.256, 0.276))
WARMUP_STEPS = 5


def arm_watchdog(cold_arm: bool = False) -> threading.Timer | None:
    """A daemon timer that prints an error JSON and exits with 3 when the
    run has not finished in time (`bench.py:36-97`): on the card it covers
    a hung first build of the kernels or a card that stopped answering, so
    a caller with a time limit gets a parseable line and not a silent kill.
    The budget is `BASD_BENCH_WATCHDOG_S` (<= 0 disables it): 1200 s, or
    2400 s for the arms that stage larger models (`--cross-arch`,
    `--teacher`).
    `BASD_BENCH_TEST_HANG` simulates a hang. Returns the timer, for
    `main` to cancel when it returns."""
    default = "2400" if cold_arm else "1200"
    budget = float(os.environ.get("BASD_BENCH_WATCHDOG_S", default))
    if budget <= 0:
        return None

    def fire():
        # the first and only line under a hang
        print(json.dumps({
            "metric": "basd_distill_throughput",
            "value": 0.0,
            "unit": "images/sec/chip",
            "vs_baseline": None,
            "error": f"watchdog: the card did not answer within {budget:.0f}s "
                     "(a hung kernel build or card) -- no measurement taken",
        }), flush=True)
        os._exit(3)

    timer = threading.Timer(budget, fire)
    timer.daemon = True
    timer.start()
    if os.environ.get("BASD_BENCH_TEST_HANG"):
        time.sleep(budget + 60)
    return timer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--imagenet", action="store_true",
                    help="Table-1 workload (ViT-Small student, 224 px, batch 256) "
                         "instead of the default Table-3 headline")
    ap.add_argument("--cross-arch", action="store_true",
                    help="Table-2 workload (ConvNeXt-V2-Tiny teacher -> DeiT-Tiny "
                         "student, 224 px, batch 256)")
    ap.add_argument("--teacher", default=None,
                    help="override the teacher preset (e.g. dinov2_vitl14, the "
                         "reference's literal Table-1 teacher)")
    ap.add_argument("--batch", type=int, default=None, help="override the batch")
    # shrink every arm to a CPU-sized wiring check; its numbers mean nothing
    ap.add_argument("--smoke", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.imagenet and args.cross_arch:
        ap.error("--imagenet and --cross-arch are mutually exclusive")
    return args


def arm_config(args: argparse.Namespace) -> dict:
    """The arm's workload and step counts, as `bench.py:147-201` sets them."""
    cfg = dict(teacher="dinov2_vitb14", remat=False)
    if args.imagenet:
        cfg.update(img_size=224, batch=256, num_classes=1000,
                   student="vit_small_patch16", overrides=None, patch=16,
                   metric="vit_small_imagenet_basd_distill_throughput", n1=4, n2=24)
    elif args.cross_arch:
        cfg.update(img_size=224, batch=256, num_classes=1000,
                   student="vit_tiny_patch16", overrides=None, patch=16,
                   teacher="convnextv2_tiny",
                   metric="vit_tiny_cross_arch_basd_distill_throughput", n1=4, n2=24)
    else:
        cfg.update(img_size=32, batch=128, num_classes=100,
                   student="vit_tiny_patch16", overrides={"patch_size": 4}, patch=4,
                   metric="vit_tiny_basd_distill_throughput", n1=10, n2=110)
    if args.teacher:
        cfg["teacher"] = args.teacher
        cfg["metric"] += f"_teacher_{args.teacher}"
    if args.smoke:
        cfg["metric"] += "_smoke"
        # the teacher's patch or stride still divides the image (ConvNeXt's
        # stride 32 needs 64 px)
        cfg.update(img_size=32 if not (args.imagenet or args.cross_arch) else 64,
                   batch=8, n1=1, n2=3)
    if args.batch:
        cfg["batch"] = args.batch
        cfg["metric"] += f"_b{args.batch}"
    return cfg


def main(argv=None, *, device=None) -> dict:
    """Run the arm and print its JSON line; returns the printed object."""
    args = parse_args(argv)
    # armed after argparse (which cannot hang), so the larger arms can
    # widen the budget
    watchdog = arm_watchdog(cold_arm=args.cross_arch or args.teacher is not None)
    try:
        return _run(args, device)
    finally:
        if watchdog is not None:
            watchdog.cancel()


def _run(args: argparse.Namespace, device) -> dict:
    dev = resolve_device(device)
    arm = arm_config(args)
    img_size, batch, num_classes = arm["img_size"], arm["batch"], arm["num_classes"]
    # the kernels' start-up check: raises naming a kernel that fails; the
    # port has no fallback to switch to
    validate_kernel_dispatches(dev, verbose=False)

    bf16 = torch.bfloat16
    teacher = load_teacher(arm["teacher"], img_size=img_size, dtype=bf16, device=dev)
    points = extraction_points(12, 4)
    student, cfg = create_student(
        arm["student"], num_classes=num_classes, drop_path_rate=0.05,
        img_size=img_size, arch_overrides=arm["overrides"], capture_layers=points,
        dtype=bf16, remat=arm["remat"], device=dev,
    )
    selector = init_selector(1, len(points), cfg.embed_dim, teacher.spec.embed_dim,
                             device=dev)

    # the host loader's raw size from the reference's eval_crop_ratio
    # resolver (crop_ratio = img / (img + 2 patch)), as bench.py
    raw = img_size + 2 * arm["patch"]
    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        (rng.random((batch, raw, raw, 3)) * 255).astype(np.uint8)).to(dev)
    labels = torch.from_numpy(
        rng.integers(0, num_classes, batch, dtype=np.int64)).to(dev)
    # staging-time subspace K, measured on the eval view as the train entry
    # point measures it
    calib = eval_view(images, img_size, img_size / raw, *TEACHER_STATS)
    subspace_k = calibrate_subspace_k(teacher, cfg.embed_dim, calib, seed=0,
                                      num_extraction_points=len(points))
    del calib

    init_fn, step_fn = make_train_step(
        student, teacher, learning_rate=5e-4, weight_decay=0.05, warmup_steps=1000,
        label_smoothing=0.01, img_size=img_size, crop_ratio=img_size / raw,
        teacher_stats=TEACHER_STATS, dataset_stats=DATASET_STATS,
        num_classes=num_classes, subspace_k=subspace_k, augment=True,
    )
    state = init_fn(0, selector)
    student_params = sum(p.numel() for p in student.parameters())

    def run(iters: int) -> tuple[float, float]:
        start = time.perf_counter()
        metrics = None
        for _ in range(iters):
            _, metrics = step_fn(state, images, labels)
        loss = float(metrics["loss"])  # the value read waits for the card
        return time.perf_counter() - start, loss

    n1, n2 = arm["n1"], arm["n2"]
    run(WARMUP_STEPS)
    t1, _ = run(n1)
    kernels.reset_launches()
    t2, loss = run(n2)
    launches = {name: count // n2 if count % n2 == 0 else count / n2
                for name, count in kernels.LAUNCHES.items()}
    step_time = (t2 - t1) / (n2 - n1)
    # the eager step: a graph replay is no torch op the count could read
    flops = step_cost_analysis(step_fn.eager, state, images, labels)["flops"]
    mfu = flops / step_time / H100_BF16_PEAK_FLOPS

    result = {
        "metric": arm["metric"],
        "value": round(batch / step_time, 2),
        "unit": "images/sec/chip",
        "vs_baseline": None,
        "detail": {
            "step_time_ms": round(1e3 * step_time, 3),
            "batch": batch,
            "chips": 1,  # one process, one card
            "teacher": arm["teacher"],
            "student": f"{arm['student']}_img{img_size}",
            "student_arch": {
                "img_size": cfg.img_size,
                "patch_size": cfg.patch_size,
                "embed_dim": cfg.embed_dim,
                "depth": cfg.depth,
                "num_heads": cfg.num_heads,
                "num_tokens": cfg.num_patches + 1,
                "params_m": round(student_params / 1e6, 3),
                "remat": arm["remat"],
            },
            "raw_input_px": raw,
            "loss": loss,
            **({"smoke": True} if args.smoke else {}),
            # unrounded: a CPU wiring check's share is far below 1e-4
            "mfu_vs_bf16_peak": mfu,
            # always empty: a kernel that fails the start-up check raises
            # before this line; nothing falls back
            "kernel_fallbacks": [],
            "launches": launches,
            # "graph" where the step is one CUDA graph (training.train_step.step_route)
            "step_route": step_fn.route,
            "device": card_line(dev),
        },
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
