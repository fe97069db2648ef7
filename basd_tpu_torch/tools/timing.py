"""Device timing of the tools: CUDA events around repeated calls."""

from __future__ import annotations

import torch


def device_ms(fn, device: torch.device, reps: int = 10, warmup: int = 2):
    """Mean ms of `fn()` on the card by CUDA events after `warmup` calls;
    None on the CPU, where there is no device time to measure."""
    if device.type != "cuda":
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def fmt_ms(ms) -> str:
    return "not measured (cpu)" if ms is None else f"{ms:9.4f} ms"
