"""Sweep count against the fp32 floor for the Jacobi eigh kernel (K3) at
the Table-1 angle shape (48, 192, 192): the port of
`tools/probe_jacobi_sweeps.py`.

    python -m basd_tpu_torch.tools.probe_jacobi_sweeps

Cyclic Jacobi needs more sweeps as n grows: the selector's sweeps=6 was
tuned at n <= 96. Per sweep count this probe gives the kernel's time (CUDA
events after warm-up) and, on two spectrum families, the error against
float64 LAPACK:

  * eig_err, max |eig - LAPACK64|;
  * d2_err, the error of the consumed quantity, the weighted
    sum_i w_i arccos(sigma_i)^2 / sum_i w_i (arccos amplifies near sigma = 1
    by 1 / sqrt(1 - sigma^2)).

The families are a uniform [0, 1]^2 spectrum (clustering near 0) and a
principal-angle spectrum: sigma in [0, 1] with a tight cluster near 1
(cross-Grams of overlapping subspaces), a spread mid-range and zeros (the
rank mask). n = 192 takes the kernel's route with V^T in device memory.
`main(**SMOKE)` runs (6, 16) at sweeps 2 and 3.
"""

from __future__ import annotations

import numpy as np
import torch

from basd_tpu_torch.device import resolve_device
from basd_tpu_torch.spectral.jacobi_kernel import kernel_jacobi_eigh
from basd_tpu_torch.tools.timing import device_ms, fmt_ms

SWEEPS = (5, 6, 7, 8, 9, 12)
SMOKE = dict(batch=6, n=16, sweeps=(2, 3))
_F32_EPS = float(np.finfo(np.float32).eps)


def make_cases(b: int, n: int, rng: np.random.Generator) -> dict:
    """The two spectrum families, (b, n, n) float64, in the JAX tool's
    draw order."""
    q = np.linalg.qr(rng.standard_normal((b, n, n)))[0]
    cases = {}
    lam = rng.random((b, n)) ** 2
    cases["uniform"] = np.einsum("bik,bk,bjk->bij", q, lam, q)
    k1 = n // 3
    sig = np.concatenate(
        [1.0 - 10.0 ** rng.uniform(-7, -2, (b, k1)),  # near-1 cluster
         rng.uniform(0.1, 0.9, (b, n - 2 * k1)),
         np.zeros((b, k1))], axis=1)
    cases["angles"] = np.einsum("bik,bk,bjk->bij", q, sig**2, q)
    return cases


def main(
    *, device=None, batch: int = 48, n: int = 192, sweeps=SWEEPS,
    reps: int = 5,
) -> list[dict]:
    """Print and return one row per (sweeps, family)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    cases = make_cases(batch, n, rng)
    want = {k: np.sort(np.linalg.eigvalsh(v), -1)[:, ::-1]
            for k, v in cases.items()}
    w = np.sort(rng.random((batch, n)), -1)[:, ::-1]  # descending weights

    def d2_of(eigvals):  # eigvals descending, = sigma^2 of the cross
        sigma = np.sqrt(np.clip(eigvals, 0.0, None))
        theta = np.arccos(np.clip(sigma, None, 1.0 - _F32_EPS))
        return (w * theta**2).sum(-1) / w.sum(-1)

    inputs = {k: torch.from_numpy(v.astype(np.float32)).to(dev)
              for k, v in cases.items()}
    rows = []
    for s in sweeps:
        ms = None
        for name, a in inputs.items():
            got = kernel_jacobi_eigh(a, sweeps=s)[0].cpu().numpy().astype(np.float64)
            eig_err = float(np.max(np.abs(got - want[name])))
            d2_err = float(np.max(np.abs(d2_of(got) - d2_of(want[name]))))
            if not rows or rows[-1]["sweeps"] != s:
                ms = device_ms(lambda: kernel_jacobi_eigh(a, sweeps=s), dev, reps)
            rows.append(dict(sweeps=s, family=name, ms=ms, eig_err=eig_err,
                             d2_err=d2_err))
            print(f"sweeps {s:2d} [{name:7s}]: {fmt_ms(ms)}  "
                  f"eig_err {eig_err:.2e}  d2_err {d2_err:.2e}", flush=True)
    return rows


if __name__ == "__main__":
    main()
