"""Device timing of the tools: CUDA events around repeated calls, the JAX
tools' slope on the host's clock, the calls' device time with the host kept
ahead of the card, and the device kernels of a torch.profiler run."""

from __future__ import annotations

import time

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


def slope_ms(fn, device: torch.device, n1: int, n2: int, warmup: int = 3):
    """ms per call of `fn()` by the JAX tools' slope: (t(n2) - t(n1)) /
    (n2 - n1) on the host's clock over runs of n1 and n2 calls, each ending
    in the host reading the last result's sum, after a run of `warmup`.
    None on the CPU."""
    if device.type != "cuda":
        return None

    def run(iters):
        t0 = time.perf_counter()
        r = None
        for _ in range(iters):
            r = fn()
        float(r.sum())
        return time.perf_counter() - t0

    run(warmup)
    t1 = run(n1)
    t2 = run(n2)
    return (t2 - t1) / (n2 - n1) * 1e3


def stage_ms(fn, device: torch.device, reps: int, warmup: int = 3):
    """`device_ms` of a tool's stage on the card; on the CPU, where no time
    is measured, one call (so the stage still runs) and None."""
    if device.type != "cuda":
        fn()
        return None
    return device_ms(fn, device, reps, warmup)


def device_events(prof):
    """The device kernels of a torch.profiler run, by name. User annotations
    (ranges such as the optimizer's step) also carry device time and are
    left out, so nothing counts twice."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_us(event) -> float:
    """An event's own device time in microseconds."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def kernel_ms(fn, device: torch.device, reps: int = 20, warmup: int = 2):
    """Device time per call of `fn()` with the card never waiting for the
    host. A spin kernel holds the card while the host enqueues `reps`
    calls; CUDA events time the calls from the spin's end, so they run back
    to back. Unlike `device_ms` this leaves out the gaps in which the card
    waits for the host to enqueue the next launch. The start event must
    still be pending when the host has enqueued the last call; if it is
    not, the spin was too short and the reading is taken again with a
    longer one. None on the CPU."""
    if device.type != "cuda":
        return None
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(device)
    # the spin's length in ms (at the card's clock of about 2 GHz): twice
    # the host's time for the last warm-up call, per call
    hold_ms = min(2.0 * reps * host_ms + 1.0, 100.0)
    for _ in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_ms * 2e6))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize(device)
        if ahead:
            return start.elapsed_time(end) / reps
        hold_ms *= 4
    raise RuntimeError(f"the host did not enqueue {reps} calls within a "
                       f"{hold_ms / 4:.1f} ms spin")


def fmt_ms(ms) -> str:
    return "not measured (cpu)" if ms is None else f"{ms:9.4f} ms"
