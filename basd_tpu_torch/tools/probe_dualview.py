"""The train views' stages at the Table-1 workload (batch 256, 256 px raw,
224 px out): the port of `tools/probe_dualview.py`.

    python -m basd_tpu_torch.tools.probe_dualview

Lines: the whole `dual_view` (its draws included), the clean view alone,
RandomResizedCrop, hflip, TrivialAugmentWide, equalize over the batch and
masked to the images that drew it (1 in 14), the geometric warp (K4, on
identity parameters as the JAX probe) and the normalization. Each is the
mean of `--n` calls by CUDA events after warm-up
(`tools/timing.py:device_ms`); images from `default_rng(0)`.
`main(argv, device="cpu", **SMOKE)` runs the JAX probe's smoke shapes on the
CPU, where no time is measured.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.ops.augment import (
    _equalize,
    _equalize_masked,
    hflip,
    normalize,
    random_resized_crop,
    sample_crop,
    sample_flip,
    sample_trivial_augment,
    trivial_augment_wide,
)
from basd_tpu_torch.ops.preprocess import (
    center_crop_resize,
    dual_view,
    sample_view_draws,
    to_float,
)
from basd_tpu_torch.ops.warp_kernel import fused_geometric_warp
from basd_tpu_torch.tools.timing import fmt_ms, stage_ms

TEACHER_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
DATASET_STATS = ((0.5,) * 3, (0.25,) * 3)
# the JAX probe's BASD_PROBE_SMOKE shapes
SMOKE = dict(b=4, raw=40, img=32)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=12, help="timed calls per stage")
    return ap.parse_args(argv)


def main(argv=None, *, device=None, b: int = 256, raw: int = 256, img: int = 224) -> dict:
    """Print one line per stage; returns {stage: ms} (None on the CPU)."""
    args = parse_args(argv)
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    u8 = torch.from_numpy((rng.random((b, raw, raw, 3)) * 255).astype(np.uint8)).to(dev)
    x = torch.from_numpy(rng.random((b, img, img, 3)).astype(np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    views = dict(img_size=img, crop_ratio=img / raw, teacher_stats=TEACHER_STATS,
                 dataset_stats=DATASET_STATS)
    results: dict = {}

    def report(label: str, fn) -> None:
        results[label.strip().rstrip(":").strip()] = ms = stage_ms(fn, dev, args.n)
        print(f"{label} {fmt_ms(ms)}", flush=True)

    report("dual_view (all):", lambda: dual_view(u8, sample_view_draws(gen, b), **views)[1])
    report("clean view only:", lambda: center_crop_resize(to_float(u8), img, img / raw))
    report("rrc            :", lambda: random_resized_crop(to_float(u8), sample_crop(gen, b), img))
    report("hflip          :", lambda: hflip(x, sample_flip(gen, b)))
    report("trivial_augment:", lambda: trivial_augment_wide(x, sample_trivial_augment(gen, b)))
    report("  equalize     :", lambda: _equalize(x))
    mask = torch.from_numpy(np.random.default_rng(1).random(b) < 1 / 14.0).to(dev)
    report("  eq masked    :", lambda: _equalize_masked(x, mask))
    zero = torch.zeros((b,), device=dev)
    report("  geo warp     :", lambda: fused_geometric_warp(x, zero, zero, zero, zero, zero))
    report("normalize      :", lambda: normalize(x, (0.5,) * 3, (0.25,) * 3))
    return results


if __name__ == "__main__":
    main()
