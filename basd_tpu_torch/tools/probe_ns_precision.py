"""The Newton-Schulz square root of the Procrustes nuclear norm in fp32
against TF32 products: the port of `tools/probe_ns_precision.py`.

    python -m basd_tpu_torch.tools.probe_ns_precision

`spectral/ops.py:nuclear_norm_pair` (the scheduled quintic
`_ns_sqrt_pair` on the token side) on b = 64 pairs of decaying-spectrum
token matrices (197 x 384, 197 x 768; condition 1e6, the JAX probe's
inputs from numpy seed 0), against the float64 SVD's nuclear norm on the
host. The JAX probe compares XLA's HIGHEST (bf16 x 6) with HIGH (bf16 x
3); the card's counterpart compares the port's fp32 products
(`spectral/ops.py:12-13`) with TF32, switched on only around this probe's
own calls. Per precision: the value's relative error (max and median),
whether the gradients are finite, and the forward's time, the mean of
`--n` calls by CUDA events after warm-up (`tools/timing.py:device_ms`).
`main(argv, device="cpu", **SMOKE)` runs it small on the CPU, where TF32
does not exist and no time is measured.
"""

from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch

from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.spectral.ops import nuclear_norm_pair
from basd_tpu_torch.tools.timing import device_ms, fmt_ms

SMOKE = dict(b=4, n=17, ds=24, dt=48)


def make_inputs(b: int, n: int, ds: int, dt: int, cond: float, seed: int):
    """The JAX probe's decaying-spectrum token matrices, draw for draw."""
    rng = np.random.default_rng(seed)

    def decay(m, d):
        u = rng.standard_normal((b, m, d))
        scale = np.geomspace(1.0, 1.0 / np.sqrt(cond), d)
        return (u * scale).astype(np.float32)

    return decay(n, ds), decay(n, dt)


@contextlib.contextmanager
def _tf32(enabled: bool):
    """TF32 products on or off for the block only."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10, help="timed calls per precision")
    return ap.parse_args(argv)


def main(argv=None, *, device=None, b: int = 64, n: int = 197, ds: int = 384,
         dt: int = 768) -> dict:
    """Print one line per precision; returns {precision: readings}."""
    args = parse_args(argv)
    dev = resolve_device(device)
    s_np, t_np = make_inputs(b, n, ds, dt, cond=1e6, seed=0)
    want = np.array([
        np.linalg.svd(s_np[i].astype(np.float64).T @ t_np[i].astype(np.float64),
                      compute_uv=False).sum()
        for i in range(b)
    ])
    s, t = torch.from_numpy(s_np).to(dev), torch.from_numpy(t_np).to(dev)
    results = {}
    for name, tf32 in (("fp32", False), ("tf32", True)):
        with _tf32(tf32):
            with torch.no_grad():
                got = nuclear_norm_pair(s, t).double().cpu().numpy()
                ms = device_ms(lambda: nuclear_norm_pair(s, t), dev, reps=args.n, warmup=3)
            si, ti = s.clone().requires_grad_(True), t.clone().requires_grad_(True)
            grads = torch.autograd.grad(nuclear_norm_pair(si, ti).sum(), (si, ti))
        rel = np.abs(got - want) / want
        finite = all(bool(torch.isfinite(g).all()) for g in grads)
        results[name] = dict(relerr_max=float(rel.max()), relerr_median=float(np.median(rel)),
                             grads_finite=finite, ms=ms)
        print(f"{name}: value relerr max {rel.max():.2e} median {np.median(rel):.2e}; "
              f"grads finite={finite}; {fmt_ms(ms)}", flush=True)
    return results


if __name__ == "__main__":
    main()
