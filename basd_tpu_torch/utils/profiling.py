"""Tracing and profiling utilities; the port of `basd_tpu/utils/profiling.py`.

  * `profile_trace`       -- a `torch.profiler` trace (host and CUDA
                            activity) around a block, written as a Chrome
                            trace (viewable in Perfetto),
  * `StepTimer`           -- host-clock step timing that synchronizes CUDA,
                            with a percentile summary,
  * `step_cost_analysis`  -- forward FLOPs of a model, counted as
                            `evaluation.metrics.count_flops` counts them.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch


@contextlib.contextmanager
def profile_trace(log_dir: str | Path):
    """Trace the block with `torch.profiler` (CPU, and CUDA when present)
    and write `log_dir/trace.json`; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class StepTimer:
    """Wall-clock step timing; every reading ends in a CUDA synchronize, so
    it times the device work, not its enqueue."""

    def __init__(self):
        self.times_ms: list[float] = []

    @contextlib.contextmanager
    def measure(self):
        _sync()
        start = time.perf_counter()
        yield
        _sync()
        self.times_ms.append((time.perf_counter() - start) * 1e3)

    def time_fn(self, fn, *args, iters: int = 20, warmup: int = 3):
        out = None
        for _ in range(warmup):
            out = fn(*args)
        for _ in range(iters):
            with self.measure():
                out = fn(*args)
        return out

    def summary(self) -> dict[str, float]:
        t = np.asarray(self.times_ms)
        return {
            "mean_ms": float(t.mean()),
            "p50_ms": float(np.percentile(t, 50)),
            "p90_ms": float(np.percentile(t, 90)),
            "min_ms": float(t.min()),
            "steps": len(t),
        }


def step_cost_analysis(model: torch.nn.Module, image_size: int,
                       in_channels: int = 3) -> dict[str, float]:
    """Forward FLOPs of one image (`evaluation.metrics.count_flops`: matrix
    products and convolutions on a CPU copy of the model; not XLA's
    count, which also has elementwise work and bytes accessed)."""
    from basd_tpu_torch.evaluation.metrics import count_flops

    return {"flops": float(count_flops(model, image_size, in_channels))}
