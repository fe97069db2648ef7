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


# ---- the JAX package's random draws, replayed as the port's draw tuples ----
# Each function makes the same `jax.random` calls, with the same splits in
# the same order, as the JAX function it names, and returns the draws that
# the port's deterministic counterpart takes.


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def jax_crop_draws(key, b: int, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                   attempts: int = 10):
    """`augment.random_resized_crop`'s draws."""
    import jax
    import jax.numpy as jnp

    from basd_tpu_torch.ops.augment import CropDraws

    k_area, k_ratio, k_i, k_j = jax.random.split(key, 4)
    return CropDraws(
        _t(jax.random.uniform(k_area, (b, attempts), minval=scale[0], maxval=scale[1])),
        _t(jax.random.uniform(k_ratio, (b, attempts), minval=jnp.log(ratio[0]),
                              maxval=jnp.log(ratio[1]))),
        _t(jax.random.uniform(k_i, (b, attempts))),
        _t(jax.random.uniform(k_j, (b, attempts))),
    )


def jax_augment_draws(key, b: int):
    """`augment.trivial_augment_wide`'s draws: op, magnitude and sign."""
    import jax
    import jax.numpy as jnp

    from basd_tpu_torch.ops.augment import AugmentDraws

    k_op, k_mag, k_sign = jax.random.split(key, 3)
    op = jax.random.randint(k_op, (b,), 0, 14)
    mag = jax.random.randint(k_mag, (b,), 0, 31).astype(jnp.float32) / 30.0
    sign = jnp.where(jax.random.bernoulli(k_sign, 0.5, (b,)), 1.0, -1.0)
    return AugmentDraws(_t(op).long(), _t(mag), _t(sign))


def jax_view_draws(key, b: int):
    """`preprocess.dual_view`'s draws."""
    import jax

    from basd_tpu_torch.ops.preprocess import ViewDraws

    k_rrc, k_flip, k_ta = jax.random.split(key, 3)
    return ViewDraws(jax_crop_draws(k_rrc, b),
                     _t(jax.random.bernoulli(k_flip, 0.5, (b,))),
                     jax_augment_draws(k_ta, b))


def jax_mix_draws(key, alpha: float = 1.0):
    """`mixup.mixup_cutmix`'s draws."""
    import jax

    from basd_tpu_torch.ops.mixup import MixDraws

    k_choice, k_lam, k_box = jax.random.split(key, 3)
    ky, kx = jax.random.split(k_box)
    return MixDraws(
        _t(jax.random.bernoulli(k_choice, 0.5)),
        _t(jax.random.beta(k_lam, alpha, alpha)),
        _t(jax.random.uniform(ky, (), minval=0.0, maxval=1.0)),
        _t(jax.random.uniform(kx, (), minval=0.0, maxval=1.0)),
    )


def jax_step_draws(state_rng, b: int):
    """The augmentation draws of one JAX train step from its state's key."""
    import jax

    from basd_tpu_torch.training.train_step import StepDraws

    _, k_view, k_mix, _ = jax.random.split(state_rng, 4)
    return StepDraws(jax_view_draws(k_view, b), jax_mix_draws(k_mix))
