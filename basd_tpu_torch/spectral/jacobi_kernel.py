"""Wrapper of the batch-parallel Jacobi eigh kernel (`csrc/jacobi_eigh.cu`).

Counterpart of `basd_tpu/spectral/pallas_jacobi.py:pallas_jacobi_eigh`:
symmetrize, pad odd n, run (n - 1) * sweeps rotation steps with A and V^T
resident on chip, strip the pad and return descending eigenvalues. The
tensor's device picks the implementation: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes the plain version
`spectral.jacobi.jacobi_eigh`, which runs the same rotations in torch ops.
"""

from __future__ import annotations

import torch

from basd_tpu_torch import kernels
from basd_tpu_torch.spectral import jacobi

# A and V^T must fit in one CTA's shared memory (227 KB): 2 n^2 fp32
MAX_N = 168


def _jacobi_raw_cuda(a: torch.Tensor, sweeps: int):
    """(B, n, n) fp32 symmetric, n even -> (w (B, n), vt (B, n, n)) in the
    kernel's final position order (unsorted)."""
    b, n, _ = a.shape
    if a.dtype != torch.float32 or not a.is_contiguous():
        raise ValueError("jacobi kernel takes contiguous fp32 (B, n, n)")
    if n % 2 or not 4 <= n <= MAX_N:
        raise ValueError(f"jacobi kernel takes even 4 <= n <= {MAX_N}, got {n}")
    w = torch.empty((b, n), dtype=torch.float32, device=a.device)
    vt = torch.empty((b, n, n), dtype=torch.float32, device=a.device)
    lib = kernels.library("jacobi_eigh")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    status = lib.basd_jacobi_eigh(
        a.data_ptr(), w.data_ptr(), vt.data_ptr(), b, n, (n - 1) * sweeps,
        stream,
    )
    kernels.check(status, "basd_jacobi_eigh")
    kernels.LAUNCHES["jacobi_eigh"] += 1
    return w, vt


def kernel_jacobi_eigh(
    a: torch.Tensor, *, sweeps: int = 9
) -> tuple[torch.Tensor, torch.Tensor]:
    """eigh of (..., n, n) symmetric batches, descending eigenvalues;
    eigvecs[..., :, i] is the i-th eigenvector. Odd n is padded."""
    if a.device.type == "cpu":
        return jacobi.jacobi_eigh(a, sweeps=sweeps)
    if a.device.type != "cuda":
        raise ValueError(f"jacobi eigh runs on cuda or cpu, not {a.device}")
    batch_shape = a.shape[:-2]
    a, n0 = jacobi.symmetrize_pad(a)
    w, vt = _jacobi_raw_cuda(a.contiguous(), sweeps)
    return jacobi.finish(w, vt.transpose(-1, -2), n0, batch_shape)
