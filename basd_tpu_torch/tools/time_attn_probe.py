"""Device time of the attention-probe kernel (K6) per variant: the
teacher's attention shape (256, 12, 257, 64), which the attention probe
runs, and (32, 12, 1024, 64), the largest N the kernel takes, on q, k, v
from the probe's own draws (`probe_attn_internals.make_inputs`).

    python -m basd_tpu_torch.tools.time_attn_probe

Each reading is `tools/timing.py:kernel_ms` on the wrapper's launches
(`ops/attn_probe.py:_probe_cuda`: 20 calls with the host kept ahead of
the card; tilemax's two launches count as one call). The cases are read in
turn, `readings` times over, and a case's time is the median of its
readings. Prints one JSON line: the library that ran (named by its
source's hash), the card's name and power limit, and per case its
readings, median ms and bound (q, k, v read once and o written once at
3.35 TB/s, or the FLOPs at 989 TFLOP/s bf16, whichever is larger).

To time another checkout's kernel on the same card, run this file by its
path with that checkout first on the module path:

    PYTHONPATH=<other checkout> python basd_tpu_torch/tools/time_attn_probe.py

The card only: there is no device time to read on the CPU.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from basd_tpu_torch import kernels
from basd_tpu_torch.ops import attn_probe
from basd_tpu_torch.tools.probe_attn_internals import make_inputs
from basd_tpu_torch.tools.timing import kernel_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS = 989e12
SHAPES = ((256, 12, 257, 64), (32, 12, 1024, 64))


def main(*, readings: int = 7, group: int = 8) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("time_attn_probe reads the card's device time; no CUDA device")
    dev = torch.device("cuda", 0)
    inputs = {shape: make_inputs(*shape, dev) for shape in SHAPES}
    times = {(shape, v): [] for shape in SHAPES for v in attn_probe.VARIANTS}
    for _ in range(readings):
        for (shape, variant), t in times.items():
            q, k, v = inputs[shape]
            t.append(kernel_ms(lambda: attn_probe._probe_cuda(q, k, v, variant, group), dev))
    rows = {}
    for (shape, variant), t in times.items():
        b, h, n, hd = shape
        bound_ms = 1e3 * max(4 * b * h * n * hd * 2 / HBM_BYTES_PER_S,
                             attn_probe.probe_flops(b, h, n, hd) / BF16_FLOPS)
        rows[f"{variant} {shape}"] = dict(readings=t, ms=float(np.median(t)),
                                         bound_ms=bound_ms)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = dict(library=kernels._lib_path("attn_probe").name, card=card,
               readings=readings, cases=rows)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("time_attn_probe: no CUDA device", file=sys.stderr)
        sys.exit(2)
    main()
