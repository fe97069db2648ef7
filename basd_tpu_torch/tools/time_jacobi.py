"""Device time of the Jacobi kernels per launch and per rotation step, on
random PSD Grams from a seed: the eigh kernel (K3) at the selector's three
shapes at n = 48, the spectral tuner's (48, 96, 96), (4, n, n) at every
even n of its ping-pong route (4..96), and above n = 96 (its packed_log
route) at (4, 128, 128), the sweeps probe's (48, 192, 192) and the edges
n = 98, 168, 170 and 238; the eigenvalues kernel (K5) at the tuner's
(12, 192, 192).

    python -m basd_tpu_torch.tools.time_jacobi

Each reading is `tools/timing.py:kernel_ms` on the raw launch
(`spectral/jacobi_kernel.py:_jacobi_raw_cuda`, `_jacobi_eigvals_raw_cuda`:
20 launches with the host kept ahead of the card). The shapes are read in
turn, `readings` times over, and a shape's time is the median of its
readings, so a drift of the card's clock spreads over all of them. Prints
one JSON line: the library that ran (named by its source's hash), the
card's name and power limit, and per shape its route, readings, median ms
and us per rotation step.

To time another checkout's kernels on the same card, run this file by its
path with that checkout first on the module path:

    PYTHONPATH=<other checkout> python basd_tpu_torch/tools/time_jacobi.py

The card only: there is no device time to read on the CPU.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from basd_tpu_torch import kernels
from basd_tpu_torch.spectral import jacobi_kernel
from basd_tpu_torch.tools.timing import kernel_ms

# (kernel, batch, n, sweeps)
SHAPES = (
    [("jacobi_eigh", b, n, 6) for b, n in [(48, 48), (12, 48), (4, 48), (48, 96)]]
    + [("jacobi_eigh", 4, n, 6) for n in range(4, 97, 2)]
    + [("jacobi_eigh", 4, n, 6) for n in (98, 128, 168, 170, 238)]
    + [("jacobi_eigh", 48, 192, 6), ("jacobi_eigvals", 12, 192, 9)]
)


def main(*, readings: int = 7, seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("time_jacobi reads the card's device time; no CUDA device")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    inputs = {}
    for shape in SHAPES:
        _, b, n, _ = shape
        x = rng.standard_normal((b, n, n)).astype(np.float32)
        inputs[shape] = torch.from_numpy(x @ x.transpose(0, 2, 1) / n).to(dev)
    raw = {"jacobi_eigh": jacobi_kernel._jacobi_raw_cuda,
           "jacobi_eigvals": jacobi_kernel._jacobi_eigvals_raw_cuda}
    # a checkout without eigvals_route runs K5's one kernel
    route_of = {"jacobi_eigh": jacobi_kernel.eigh_route,
                "jacobi_eigvals": getattr(jacobi_kernel, "eigvals_route", lambda n: "single")}
    times = {shape: [] for shape in inputs}
    for _ in range(readings):
        for (name, b, n, sweeps), a in inputs.items():
            fn = raw[name]
            times[(name, b, n, sweeps)].append(kernel_ms(lambda: fn(a, sweeps), dev))
    rows = {}
    for (name, b, n, sweeps), t in times.items():
        ms = float(np.median(t))
        rows[f"{name} ({b}, {n}, {n}) sweeps {sweeps}"] = dict(
            route=route_of[name](n),
            readings=t, ms=ms, us_per_step=ms * 1e3 / ((n - 1) * sweeps))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = dict(library=kernels._lib_path("jacobi_eigh").name, card=card,
               readings=readings, shapes=rows)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("time_jacobi: no CUDA device", file=sys.stderr)
        sys.exit(2)
    main()
