"""Tracing utility; the port of `basd_tpu/utils/profiling.py`'s trace.

  * `profile_trace` -- a `torch.profiler` trace (host and CUDA activity)
                       around a block, written as a Chrome trace (viewable
                       in Perfetto).

The forward FLOPs of one image of a model are `evaluation.metrics.count_flops`;
the train step's time and work are measured by `benchmark/run.py`.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

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
