"""Device time of the TrivialAugment warp kernel (K4) per launch: the
Table-3 batch (128, 32, 32, 3) and the reference's default batch at 224 px
(256, 224, 224, 3), on uniform images from a seed, each with three sets of
warp parameters: `edge_mix` (the rows chip_smoke.py checks: every geometric
op at its extremes, a third of them quarter-turned), every sample
unturned (k = 0) and every sample quarter-turned (k = 1), half of each
flipped.

    python -m basd_tpu_torch.tools.time_warp

Each reading of device time is `tools/timing.py:kernel_ms` on the raw
launch (`ops/warp_kernel.py:_warp_cuda`: 20 launches with the host kept
ahead of the card). Each case is also read by an event loop of 100 wrapper
calls (`loop_ms`, as chip_smoke.py's "ms": CUDA events around the loop,
as `timing.device_ms` takes them) and by the host's clock per call while
that loop is enqueued (`host_ms`, the wrapper's own cost). The cases are read in turn, `readings` times
over, and a case's time is the median of its readings. Prints one JSON
line: the library that ran (named by its source's hash), the card's name
and power limit, and per case its readings, median ms, median loop_ms and
host_ms, and bound (one read and one write of the batch at 3.35 TB/s).

To time another checkout's kernel on the same card, run this file by its
path with that checkout first on the module path:

    PYTHONPATH=<other checkout> python basd_tpu_torch/tools/time_warp.py

The card only: there is no device time to read on the CPU.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from basd_tpu_torch import kernels
from basd_tpu_torch.ops import warp_kernel as wk
from basd_tpu_torch.tools.timing import kernel_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SHAPES = ((128, 32, 3), (256, 224, 3))
_NAMES = ("angle", "shear_x", "shear_y", "trans_x", "trans_y")


def edge_ops() -> list[tuple[str, float]]:
    """Every geometric op at its extremes (shear +-0.99, translate +-32,
    rotate +-135 and +-45 degrees, exact quarter turns), a fractional
    translation and identity (angles in degrees)."""
    ops = [("angle", 0.0)]
    for v in (0.99, -0.99):
        ops += [("shear_x", v), ("shear_y", v)]
    for v in (32.0, -32.0, 3.7):
        ops += [("trans_x", v), ("trans_y", v)]
    return ops + [("angle", d) for d in (135, -135, 45, -45, 30, 90, 180, -90, 270)]


def edge_mix(b: int, ops=None) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
    """The five op magnitudes (angle in radians) and the flip mask of b
    samples on the CPU: sample i takes op (i // 2) mod len(ops), and odd
    samples are flipped."""
    ops = edge_ops() if ops is None else ops
    vals = {k: torch.zeros(b) for k in _NAMES}
    for i in range(b):
        kind, v = ops[(i // 2) % len(ops)]
        vals[kind][i] = v * math.pi / 180 if kind == "angle" else v
    return tuple(vals[k] for k in _NAMES), torch.arange(b) % 2 == 1


def _params(b: int, mix: str, dev: torch.device) -> torch.Tensor:
    if mix == "edge_mix":
        vals, flip = edge_mix(b)
    else:
        angle = 0.3 if mix == "unturned" else 1.7  # radians: k = 0 or 1
        z = torch.zeros(b)
        vals, flip = (z + angle, z + 0.1, z, z + 2.5, z), torch.arange(b) % 2 == 1
    return wk.warp_params(*(v.to(dev) for v in vals), flip.to(dev))


def _host_and_loop_ms(fn, dev: torch.device, reps: int = 100) -> tuple[float, float]:
    """(host ms per call while enqueuing `reps` calls, event-loop ms per
    call): `timing.device_ms`'s loop, with the host's clock around the
    enqueuing alone."""
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    torch.cuda.synchronize(dev)
    return host_ms, start.elapsed_time(end) / reps


def main(*, readings: int = 7, seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("time_warp reads the card's device time; no CUDA device")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    cases = {}
    for b, n, c in SHAPES:
        x = torch.from_numpy(rng.random((b, n, n, c), dtype=np.float32)).to(dev)
        for mix in ("edge_mix", "unturned", "quarter_turned"):
            cases[(b, n, c, mix)] = (x, _params(b, mix, dev))
    times = {key: ([], [], []) for key in cases}
    for _ in range(readings):
        for key, (x, params) in cases.items():
            fn = lambda: wk._warp_cuda(x, params)
            dev_t, host_t, loop_t = times[key]
            dev_t.append(kernel_ms(fn, dev))
            host, loop = _host_and_loop_ms(fn, dev)
            host_t.append(host)
            loop_t.append(loop)
    rows = {}
    for (b, n, c, mix), (t, host_t, loop_t) in times.items():
        # a checkout without warp_route runs its one kernel
        route = getattr(wk, "warp_route", lambda n, c: "single")(n, c)
        rows[f"({b}, {n}, {n}, {c}) {mix}"] = dict(
            route=route, readings=t, ms=float(np.median(t)),
            loop_ms=float(np.median(loop_t)), host_ms=float(np.median(host_t)),
            bound_ms=2 * 4 * b * n * n * c / HBM_BYTES_PER_S * 1e3)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = dict(library=kernels._lib_path("warp").name, card=card,
               readings=readings, cases=rows)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("time_warp: no CUDA device", file=sys.stderr)
        sys.exit(2)
    main()
