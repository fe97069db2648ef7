"""Shared builders for the `basd_tpu_torch` parity tests (no tests here).

The port is held against the JAX package on the CPU: inputs come from
numpy seeds, weights are made by the JAX package and carried onto the
port with the port's own `vit_state_dict_from_jax`, and results come back
as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

CPU = torch.device("cpu")


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def t32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def psd(b: int, n: int, seed: int = 0) -> np.ndarray:
    """Random symmetric PSD batch (the JAX Jacobi tests' matrices)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, n)).astype(np.float32)
    return (x @ np.swapaxes(x, 1, 2)) / n


def planted_tokens(shape, rank: int, seed: int, noise: float = 0.3) -> np.ndarray:
    """(..., M, D) tokens: a rank-`rank` signal plus isotropic noise, so MP
    ranks are well inside (0, D) and well separated from the threshold."""
    rng = np.random.default_rng(seed)
    *lead, m, d = shape
    u = rng.standard_normal((*lead, m, rank)) * (2.0 + rng.random(rank) * 3)
    x = u @ rng.standard_normal((*lead, rank, d)) / np.sqrt(rank)
    return (x + noise * rng.standard_normal(shape)).astype(np.float32)


def flax_params_np(params):
    """A flax param tree as nested dicts of float32 numpy arrays."""
    if isinstance(params, dict) or hasattr(params, "items"):
        return {k: flax_params_np(v) for k, v in params.items()}
    return np.asarray(params, np.float32)


def carry_vit(jax_params, module) -> None:
    """Load a flax ViT param tree onto a port ViT (strict key match)."""
    from basd_tpu_torch.models.convert import vit_state_dict_from_jax

    sd = vit_state_dict_from_jax(flax_params_np(jax_params))
    module.load_state_dict(sd, strict=True)


def grads_as_state_dict(jax_grads) -> dict[str, np.ndarray]:
    """A flax gradient tree in the port's state-dict layout (the converter
    maps gradients exactly as it maps weights: both are linear maps)."""
    from basd_tpu_torch.models.convert import vit_state_dict_from_jax

    return {k: v.numpy() for k, v in
            vit_state_dict_from_jax(flax_params_np(jax_grads)).items()}


def assert_close(got, want, rtol: float, what: str = "") -> None:
    """max |got - want| <= rtol * max |want| (a scale-relative bound)."""
    got, want = to_np(got), to_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: max err {err:.3g} > {rtol} * {scale:.3g}"
