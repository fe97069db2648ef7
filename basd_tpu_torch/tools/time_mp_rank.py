"""Device time of the MP-rank kernel (`csrc/mp_rank.cu`) beside its plain
version and the library's eigenvalues, on random covariances from a seed:
the selector's teacher Grams of Table-3 (12, 192, 192) and Table-1
(24, 384, 384) with their sample counts, and the cluster routes' edges.

    python -m basd_tpu_torch.tools.time_mp_rank

Per shape: the kernel by `tools/timing.py:kernel_ms` on the raw launch
(`spectral/mp_rank_kernel.py:mp_rank_raw_cuda`, the host kept ahead of the
card), at the cluster the wrapper picks. At the cells' shapes besides: the
plain version (`spectral/tridiag.py:mp_rank_sturm`) as the step runs it,
one CUDA graph replayed (after WARM_S of replays), by CUDA events over the
replays, with its kernel count; `torch.linalg.eigvalsh` (cuSOLVER, which
waits on the host) by `device_ms`. Readings are taken in turn, `readings`
times over, and each time is their median. Prints one JSON line with the
card's name and power limit. The card only.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from basd_tpu_torch import kernels
from basd_tpu_torch.spectral.mp_rank_kernel import (
    cluster_size,
    mp_covariance,
    mp_rank_raw_cuda,
    smem_bytes,
)
from basd_tpu_torch.spectral.tridiag import mp_rank_sturm
from basd_tpu_torch.tools.timing import device_events, device_ms, kernel_ms

# (batch, n, m): Table-3's teacher Grams (12 layers, D_s 192, 128 x 5
# tokens), Table-1's (24 layers, D_s 384, 256 x 257 tokens), the edges of
# the one- and two-CTA routes and two n on eight CTAs
SHAPES = ((12, 192, 640), (24, 384, 65792), (4, 238, 952), (4, 239, 956),
          (4, 512, 2048), (2, 640, 2560))
PLAIN_SHAPES = ((12, 192, 640), (24, 384, 65792))
WARM_S = 6.0


def grams(b: int, n: int, m: int, seed: int) -> torch.Tensor:
    """(b, n, n) fp32 Grams X^T X of m Gaussian samples on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, min(m, 4 * n), n), generator=g, device="cuda")
    return (x.transpose(1, 2) @ x) * (m / x.shape[1])


def plain_replay_ms(gram: torch.Tensor, m: int, reps: int = 5) -> tuple[float, int]:
    """(ms a replay, kernels a replay) of `mp_rank_sturm` captured as one
    CUDA graph after a warm-up call on a side stream."""
    from torch.profiler import ProfilerActivity, profile

    cov = mp_covariance(gram, m)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mp_rank_sturm(cov, m)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        mp_rank_sturm(cov, m)
    # replays for WARM_S first: a new graph runs its kernels with wider gaps
    # for its first seconds (PERF.md)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < WARM_S:
        graph.replay()
        torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    count = sum(e.count for e in device_events(prof))
    return start.elapsed_time(end) / reps, count


def main(*, readings: int = 5, seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("time_mp_rank reads the card's device time; no CUDA device")
    dev = torch.device("cuda", 0)
    cases = {(b, n, m): grams(b, n, m, seed + i) for i, (b, n, m) in enumerate(SHAPES)}
    times = {key: [] for key in cases}
    for _ in range(readings):
        for (b, n, m), gram in cases.items():
            times[(b, n, m)].append(kernel_ms(lambda: mp_rank_raw_cuda(gram, m), dev))
    rows = {}
    for (b, n, m), t in times.items():
        c = cluster_size(n)
        rows[f"kernel ({b}, {n}, {n}) m {m} cluster {c}"] = dict(
            readings=t, ms=float(np.median(t)), cluster=c, smem_bytes=smem_bytes(n, c))
    for i, (b, n, m) in enumerate(PLAIN_SHAPES):
        gram = grams(b, n, m, seed + i)
        ms, count = plain_replay_ms(gram, m)
        cov = mp_covariance(gram, m)
        rows[f"plain ({b}, {n}, {n}) m {m}"] = dict(ms=ms, kernels=count)
        rows[f"eigvalsh ({b}, {n}, {n})"] = dict(
            ms=device_ms(lambda: torch.linalg.eigvalsh(cov), dev, reps=5))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = dict(library=kernels._lib_path("mp_rank").name, card=card, readings=readings,
               shapes=rows)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("time_mp_rank: no CUDA device", file=sys.stderr)
        sys.exit(2)
    main()
