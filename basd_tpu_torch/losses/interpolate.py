"""Parameter-free token-grid alignment as a precomputed matrix
(`basd_tpu/losses/interpolate.py`): torch's half-pixel linear rule
(`F.interpolate(mode="linear", align_corners=False)`) as one matmul. The
matrix is a device constant, copied to its device once per shape, so a
train step copies nothing from the host."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from basd_tpu_torch.device import device_constant


@lru_cache(maxsize=None)
def linear_interp_matrix(n_out: int, n_in: int) -> np.ndarray:
    """W with (W @ x) == F.interpolate(x, n_out, mode='linear',
    align_corners=False) for a length-n_in signal x."""
    w = np.zeros((n_out, n_in), dtype=np.float32)
    if n_in == 1:
        w[:, 0] = 1.0
        return w
    scale = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        src = min(max(src, 0.0), n_in - 1.0)
        i0 = int(np.floor(src))
        i1 = min(i0 + 1, n_in - 1)
        frac = src - i0
        w[i, i0] += 1.0 - frac
        w[i, i1] += frac
    return w


@device_constant
def interp_matrix(n_out: int, n_in: int, device: torch.device) -> torch.Tensor:
    """`linear_interp_matrix` on `device`."""
    return torch.from_numpy(linear_interp_matrix(n_out, n_in)).to(device)


def align_token_count(tokens: torch.Tensor, n_out: int) -> torch.Tensor:
    """(..., N_in, D) -> (..., n_out, D) fp32 by linear interpolation over
    the token axis."""
    n_in = tokens.shape[-2]
    if n_in == n_out:
        return tokens
    return interp_matrix(n_out, n_in, tokens.device) @ tokens.float()


def align_vector(values: torch.Tensor, n_out: int) -> torch.Tensor:
    """(..., N_in) -> (..., n_out), same rule."""
    n_in = values.shape[-1]
    if n_in == n_out:
        return values
    return values.float() @ interp_matrix(n_out, n_in, values.device).T
