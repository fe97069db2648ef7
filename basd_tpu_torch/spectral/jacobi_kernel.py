"""Wrappers of the batch-parallel Jacobi kernels (`csrc/jacobi_eigh.cu`):
eigh (K3) and eigenvalues only (K5).

Counterparts of `basd_tpu/spectral/pallas_jacobi.py:pallas_jacobi_eigh`
and `pallas_jacobi_eigvals`: symmetrize, pad odd n, run (n - 1) * sweeps
rotation steps with A resident on chip, then finish on the host side of
the kernel. K3 strips the pad through the eigenvector and returns
descending eigenvalues; K5 returns them ascending and drops the pad as the
entry of smallest |w|. The tensor's device picks the implementation: a
CUDA tensor launches the kernel (or raises), a CPU tensor takes the plain
version (`spectral.jacobi.jacobi_eigh`, `jacobi_eigvals`), which runs the
same rotations in torch ops.
"""

from __future__ import annotations

import torch

from basd_tpu_torch import kernels
from basd_tpu_torch.spectral import jacobi

# K3's routes by n, chosen here and nowhere else (the library's entry
# points only refuse an n that they were not built for or that does not
# fit): to n = 96, the selector's gate, A and V^T in two ping-pong buffers
# each (four padded n x n fp32 buffers in one CTA's 227 KB of shared
# memory); above, to n = 238, two launches: K5's packed kernel (A alone as
# its upper block triangle in two buffers, which fit up to n = 238) writing
# each step's rotations to a log in device memory, then V^T rebuilt from
# the log column-parallel.
MAX_N_PINGPONG = 96
MAX_N = 238


def eigh_route(n: int) -> str:
    """K3's route at even n, the one `_jacobi_raw_cuda` launches:
    "pingpong" (`basd_jacobi_eigh_pingpong`) or "packed_log"
    (`basd_jacobi_eigh_packed_log`, then `basd_jacobi_eigh_vt_replay`)."""
    return "pingpong" if n <= MAX_N_PINGPONG else "packed_log"


def log_pairs(n: int) -> int:
    """float2 per step of the packed_log route's rotation log: the n/2
    rotations (c, s), rounded up to even so that every step's row starts
    16-byte aligned (the replay loads rows by 16-byte cp.async)."""
    return (n // 2 + 1) // 2 * 2


def eigvals_route(n: int) -> str:
    """K5's route at even 4 <= n <= 238, the one `_jacobi_eigvals_raw_cuda`
    launches: "packed" (`basd_jacobi_eigvals_packed`), A's upper block
    triangle in two shared-memory buffers, at every n. The library runs it
    with n at run time, or with n a compile-time constant at the spectral
    tuner's n = 192 (6% less device time there, PERF.md §6)."""
    if n % 2 or not 4 <= n <= MAX_N:
        raise ValueError(f"jacobi eigenvalues kernel takes even 4 <= n <= {MAX_N}, got {n}")
    return "packed"


def _check(a: torch.Tensor) -> tuple[int, int]:
    b, n, _ = a.shape
    if a.dtype != torch.float32 or not a.is_contiguous():
        raise ValueError("jacobi kernel takes contiguous fp32 (B, n, n)")
    if n % 2 or not 4 <= n <= MAX_N:
        raise ValueError(f"jacobi kernel takes even 4 <= n <= {MAX_N}, got {n}")
    return b, n


def _stream(a: torch.Tensor) -> int:
    return torch.cuda.current_stream(a.device).cuda_stream


def _jacobi_raw_cuda(a: torch.Tensor, sweeps: int):
    """(B, n, n) fp32 symmetric, n even -> (w (B, n), vt (B, n, n)) in the
    kernel's final position order (unsorted)."""
    b, n = _check(a)
    w = torch.empty((b, n), dtype=torch.float32, device=a.device)
    vt = torch.empty((b, n, n), dtype=torch.float32, device=a.device)
    lib = kernels.library("jacobi_eigh")
    route = eigh_route(n)
    steps = (n - 1) * sweeps
    if route == "pingpong":
        status = lib.basd_jacobi_eigh_pingpong(
            a.data_ptr(), w.data_ptr(), vt.data_ptr(), b, n, steps, _stream(a))
    else:
        log = torch.empty((b, steps, log_pairs(n), 2), dtype=torch.float32,
                          device=a.device)
        status = lib.basd_jacobi_eigh_packed_log(
            a.data_ptr(), w.data_ptr(), log.data_ptr(), b, n, steps, _stream(a))
        kernels.check(status, f"jacobi_eigh route {route} (rotations)")
        status = lib.basd_jacobi_eigh_vt_replay(
            log.data_ptr(), vt.data_ptr(), b, n, steps, _stream(a))
    kernels.check(status, f"jacobi_eigh route {route}")
    kernels.LAUNCHES["jacobi_eigh"] += 1  # one a call, on either route
    return w, vt


def _jacobi_eigvals_raw_cuda(a: torch.Tensor, sweeps: int) -> torch.Tensor:
    """(B, n, n) fp32 symmetric, n even -> w (B, n), unsorted."""
    b, n = _check(a)
    w = torch.empty((b, n), dtype=torch.float32, device=a.device)
    lib = kernels.library("jacobi_eigh")
    route = eigvals_route(n)
    status = lib.basd_jacobi_eigvals_packed(
        a.data_ptr(), w.data_ptr(), b, n, (n - 1) * sweeps, _stream(a)
    )
    kernels.check(status, f"jacobi_eigvals route {route}")
    kernels.LAUNCHES["jacobi_eigvals"] += 1
    return w


def _on_cuda(a: torch.Tensor, what: str) -> bool:
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"jacobi {what} runs on cuda or cpu, not {a.device}")
    return a.device.type == "cuda"


def kernel_jacobi_eigh(
    a: torch.Tensor, *, sweeps: int = 9
) -> tuple[torch.Tensor, torch.Tensor]:
    """eigh of (..., n, n) symmetric batches, descending eigenvalues;
    eigvecs[..., :, i] is the i-th eigenvector. Odd n is padded."""
    if not _on_cuda(a, "eigh"):
        return jacobi.jacobi_eigh(a, sweeps=sweeps)
    batch_shape = a.shape[:-2]
    a, n0 = jacobi.symmetrize_pad(a)
    w, vt = _jacobi_raw_cuda(a.contiguous(), sweeps)
    return jacobi.finish(w, vt.transpose(-1, -2), n0, batch_shape)


def kernel_jacobi_eigvals(a: torch.Tensor, *, sweeps: int = 9) -> torch.Tensor:
    """Eigenvalues (ascending, eigvalsh-compatible) of (..., n, n)
    symmetric batches. Odd n is padded and the pad's zero dropped."""
    if not _on_cuda(a, "eigvals"):
        return jacobi.jacobi_eigvals(a, sweeps=sweeps)
    batch_shape = a.shape[:-2]
    a, n0 = jacobi.symmetrize_pad(a)
    w = _jacobi_eigvals_raw_cuda(a.contiguous(), sweeps)
    return jacobi.finish_eigvals(w, n0, batch_shape)
