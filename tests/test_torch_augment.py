"""The augmented input path of the port (`ops/augment.py`, `ops/mixup.py`,
`preprocess.dual_view`) against the JAX package, fp32 on the CPU. Inputs
come from numpy seeds; where the JAX function draws from a key, its draws
are replayed (tests/test_torch_helpers.py) and fed to the port's
deterministic function.

The port evaluates the JAX package's expressions op by op, as eager JAX
does. Under `jax.jit`, XLA rewrites a division by a constant into a
multiply by its rounded reciprocal and folds chains of constant
multiplies, which moves results by an ulp; at the +-135 degree rotation
that picks the other quarter-turn (see
`test_jitted_jax_lands_off_the_135_degree_tie`). So the tests that reach
those expressions compare with eager JAX."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basd_tpu.ops import augment as jaug
from basd_tpu.ops.mixup import mixup_cutmix as jax_mixup_cutmix
from basd_tpu.ops.preprocess import dual_view as jax_dual_view
from basd_tpu_torch.ops import augment as taug
from basd_tpu_torch.ops.mixup import MixDraws, mixup_cutmix
from basd_tpu_torch.ops.preprocess import dual_view
from test_torch_helpers import (
    jax_augment_draws,
    jax_crop_draws,
    jax_mix_draws,
    jax_view_draws,
)

torch.set_num_threads(1)

TEACHER_STATS = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
DATASET_STATS = ((0.507, 0.487, 0.441), (0.267, 0.256, 0.276))
OPS = ["identity", "shear_x", "shear_y", "translate_x", "translate_y",
       "rotate", "brightness", "color", "contrast", "sharpness", "posterize",
       "solarize", "autocontrast", "equalize"]
BINS = (0, 1, 15, 29, 30)  # magnitude bins of each op in the explicit batch


def _images(shape, seed, power=1.0):
    return (np.random.default_rng(seed).random(shape) ** power).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---- TrivialAugmentWide, each op with explicit parameters ----


def _jax_trivial_augment(x, op, mag_bin, positive, flip=None):
    """The JAX package's `trivial_augment_wide` with its three draws (op,
    magnitude bin, sign) replaced by the given arrays."""
    def randint(key, shape, minval, maxval):
        return jnp.asarray(op if maxval == 14 else mag_bin, jnp.int32)

    def bernoulli(key, p, shape):
        return jnp.asarray(positive)

    with mock.patch.object(jax.random, "randint", randint), \
            mock.patch.object(jax.random, "bernoulli", bernoulli):
        return np.asarray(jaug.trivial_augment_wide(
            jnp.asarray(x), jax.random.PRNGKey(0),
            flip_mask=None if flip is None else jnp.asarray(flip)))


@pytest.fixture(scope="module")
def explicit_batch():
    """Every op at magnitude bins 0, 1, 15, 29 and 30, each with both signs,
    on 16 px images (posterize at 8 and 2 bits, solarize at threshold 1
    and 0, shear 0.99, translate 32, rotate 135 degrees), through eager
    JAX."""
    op = np.repeat(np.arange(14), 2 * len(BINS)).astype(np.int32)
    mag_bin = np.tile(np.repeat(np.int32(BINS), 2), 14)
    positive = np.tile([True, False], 14 * len(BINS))
    x = _images((len(op), 16, 16, 3), 0, power=2.0)
    x[::7, :4] = 1.0  # saturated rows, for autocontrast and solarize
    want = _jax_trivial_augment(x, op, mag_bin, positive)
    draws = taug.AugmentDraws(
        _t(op).long(), _t(mag_bin.astype(np.float32) / np.float32(30.0)),
        _t(np.where(positive, 1.0, -1.0).astype(np.float32)))
    got = taug.trivial_augment_wide(_t(x), draws).numpy()
    return op, x, got, want


@pytest.mark.parametrize("name", OPS)
def test_each_op_with_explicit_parameters(explicit_batch, name):
    """Each op on its own samples: atol 1e-6. Equalize is exact in uint8;
    its float differs by an ulp, because the JAX package's packed equalize
    branch (batch > 64) runs compiled, where /255 is a multiply."""
    op, x, got, want = explicit_batch
    sel = op == OPS.index(name)
    np.testing.assert_allclose(got[sel], want[sel], atol=1e-6, rtol=0)
    if name == "equalize":
        np.testing.assert_array_equal(np.rint(got[sel] * 255), np.rint(want[sel] * 255))
    if name != "identity":
        assert np.abs(got[sel] - x[sel]).max() > 1e-3  # the op did act


def test_blur3_matches_jax():
    x = _images((3, 13, 17, 3), 1)
    np.testing.assert_allclose(taug._blur3(_t(x)).numpy(),
                               np.asarray(jaug._blur3(jnp.asarray(x))), atol=1e-6)


def test_autocontrast_matches_jax():
    x = _images((4, 12, 12, 3), 2) * 0.5 + 0.2
    x[1, :, :, 0] = 0.3  # a constant channel keeps its values
    np.testing.assert_allclose(taug._autocontrast(_t(x)).numpy(),
                               np.asarray(jaug._autocontrast(jnp.asarray(x))),
                               atol=1e-6)


@pytest.mark.parametrize("size", [16, 96])
def test_equalize_is_exactly_jax(size):
    """Both sides of the JAX package's 8192-pixel switch (16^2 one-hot,
    96^2 radix-16), with a constant channel, a two-value channel and a
    saturated one."""
    x = _images((3, size, size, 3), size, power=2.0)
    x[0, :, :, 1] = 0.5
    x[1, :, :, 2] = np.where(x[1, :, :, 2] > 0.5, 0.9, 0.1)
    x[2, :, :, 0] = 1.0
    np.testing.assert_array_equal(taug._equalize(_t(x)).numpy(),
                                  np.asarray(jaug._equalize(jnp.asarray(x))))


@pytest.mark.parametrize("capacity", [None, 2])
def test_equalize_masked_is_exactly_jax(capacity):
    """Against the JAX package's full branch bit for bit, and its packed
    branch (capacity 2, compiled under lax.cond, where /255 is a multiply)
    exactly in uint8; the unselected samples are the input."""
    x = _images((6, 16, 16, 3), 4, power=2.0)
    mask = np.array([True, False, False, True, True, False])
    want = np.asarray(jaug._equalize_masked(jnp.asarray(x), jnp.asarray(mask), capacity))
    got = taug._equalize_masked(_t(x), _t(mask)).numpy()
    if capacity is None:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.rint(got * 255), np.rint(want * 255))
    np.testing.assert_array_equal(got[~mask], x[~mask])


def test_affine_warp_matches_jax():
    """The non-square branch's bilinear gather with zero fill: rotation,
    shear and translation matrices at 24 x 40: atol 1e-6."""
    b = 4
    angle = np.float32([0.3, -2.0, 0.0, 0.0])
    shx = np.float32([0.0, 0.0, 0.7, 0.0])
    shy = np.float32([0.0, 0.0, 0.0, -0.5])
    tx = np.float32([0.0, 3.5, 0.0, -12.25])
    ty = np.float32([2.0, 0.0, -7.5, 0.0])
    mats = taug._inverse_affine(*(_t(v) for v in (angle, shx, shy, tx, ty)))
    x = _images((b, 24, 40, 3), 6)
    want = np.asarray(jaug._affine_warp(jnp.asarray(x), jnp.asarray(mats.numpy())))
    np.testing.assert_allclose(taug._affine_warp(_t(x), mats).numpy(), want,
                               atol=1e-6)


# ---- whole functions from replayed draws ----


@pytest.mark.parametrize("raw,seed", [(40, 0), (23, 1)])
def test_random_resized_crop_from_replayed_draws(raw, seed):
    """40 -> 32 px as in the step, and a non-square 23 x 31 source; atol
    1e-5."""
    x = _images((16, raw, raw + 8 * (raw != 40), 3), seed)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jaug.random_resized_crop(jnp.asarray(x), key, 32))
    got = taug.random_resized_crop(_t(x), jax_crop_draws(key, 16), 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_random_resized_crop_fallback_and_first_valid_attempt():
    """No valid attempt (scale above 1): the largest in-ratio centre crop,
    as JAX. One valid attempt among invalid ones: that attempt's crop."""
    x = _images((4, 20, 30, 3), 2)
    key = jax.random.PRNGKey(3)
    want = jaug.random_resized_crop(jnp.asarray(x), key, 12, scale=(1.5, 2.0))
    draws = jax_crop_draws(key, 4, scale=(1.5, 2.0))
    got = taug.random_resized_crop(_t(x), draws, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    frac = draws.area_frac.clone()
    frac[:, 4] = 0.25  # attempt 4 fits; 0-3 do not
    ratio = torch.zeros_like(frac)
    picked = taug.random_resized_crop(_t(x), draws._replace(area_frac=frac,
                                                            log_ratio=ratio), 12)
    only = taug.random_resized_crop(_t(x), taug.CropDraws(
        *(d[:, 4:5] for d in (frac, ratio, draws.u_i, draws.u_j))), 12)
    np.testing.assert_array_equal(picked.numpy(), only.numpy())


@pytest.fixture(scope="module")
def replayed_trivial_augment():
    """B = 96 at 16 px from one key, with a flip mask: the JAX package runs
    its XLA warp with the conjugated flip, the port the fused warp's plain
    version with the flip folded in."""
    b = 96
    x = _images((b, 16, 16, 3), 8, power=1.5)
    key, kf = jax.random.split(jax.random.PRNGKey(21))
    flip = jax.random.bernoulli(kf, 0.5, (b,))
    want = np.asarray(jax.jit(
        lambda x, k, f: jaug.trivial_augment_wide(x, k, flip_mask=f))(
            jnp.asarray(x), key, flip))
    draws = jax_augment_draws(key, b)
    got = taug.trivial_augment_wide(_t(x), draws, flip_mask=_t(flip))
    return draws, got.numpy(), want


def test_trivial_augment_from_replayed_draws(replayed_trivial_augment):
    """Against the compiled JAX function: atol 1e-5. These draws hold no
    +-135 degree rotation, where compiled JAX picks the other quarter-turn
    (the explicit batch covers it against eager JAX)."""
    draws, got, want = replayed_trivial_augment
    assert set(draws.op.tolist()) == set(range(14))  # every op is drawn
    assert not ((draws.op == taug.OP_ROTATE) & (draws.mag == 1.0)).any()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_jitted_jax_lands_off_the_135_degree_tie():
    """135 degrees in fp32 over pi/2 is exactly 1.5 op by op, which rounds
    to the quarter-turn k = 2, in eager JAX and in the port. Compiled, XLA
    folds the constant multiplies and gets 1.4999999, so k = 1: a
    different (equally valid) decomposition of the same rotation, whose
    image differs at the zero-filled corners."""
    sm = jnp.float32([1.0, -1.0])

    def quarter(sm):
        angle = jnp.where(sm != 0, sm * 135.0, 0.0) * (jnp.pi / 180.0)
        return jnp.round(angle / (jnp.pi / 2.0))

    np.testing.assert_array_equal(np.asarray(quarter(sm)), [2.0, -2.0])
    np.testing.assert_array_equal(np.asarray(jax.jit(quarter)(sm)), [1.0, -1.0])
    z = torch.zeros(2)
    angle = torch.where(_t(sm) != 0, _t(sm) * 135.0, 0.0) * (np.pi / 180.0)
    rows = taug.warp_kernel.warp_params(angle, z, z, z, z)
    np.testing.assert_array_equal(rows[:, 5].numpy(), [2.0, 2.0])


def test_trivial_augment_nonsquare_from_replayed_draws():
    """The gather branch (24 x 32) with a flip mask: atol 1e-5."""
    b = 24
    x = _images((b, 24, 32, 3), 9)
    key, kf = jax.random.split(jax.random.PRNGKey(5))
    flip = jax.random.bernoulli(kf, 0.5, (b,))
    want = np.asarray(jax.jit(
        lambda x, k, f: jaug.trivial_augment_wide(x, k, flip_mask=f))(
            jnp.asarray(x), key, flip))
    got = taug.trivial_augment_wide(_t(x), jax_augment_draws(key, b),
                                    flip_mask=_t(flip))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_dual_view_from_replayed_draws(explicit_batch):
    """uint8 20 px -> both 16 px views (RRC, clip, flip, TrivialAugment,
    two normalizations) against eager JAX: atol 1e-5. The batch has the
    explicit batch's shape, so eager JAX reuses its compiled ops."""
    b = len(explicit_batch[0])
    images = (np.random.default_rng(10).random((b, 20, 20, 3)) * 255).astype(np.uint8)
    key = jax.random.PRNGKey(17)
    kw = dict(img_size=16, crop_ratio=16 / 20, teacher_stats=TEACHER_STATS,
              dataset_stats=DATASET_STATS)
    want = jax_dual_view(jnp.asarray(images), key, **kw)
    got = dual_view(_t(images), jax_view_draws(key, b), **kw)
    for g, w in zip(got, want):
        assert g.shape == (b, 16, 16, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("seed", range(6))
def test_mixup_cutmix_from_replayed_draws(seed):
    """Images and soft targets at atol 1e-5; the seeds cover both
    branches."""
    x = _images((8, 12, 12, 3), seed)
    labels = np.random.default_rng(seed).integers(0, 10, 8).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    want = jax_mixup_cutmix(jnp.asarray(x), jnp.asarray(labels), key, num_classes=10)
    got = mixup_cutmix(_t(x), _t(labels), jax_mix_draws(key), num_classes=10)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    np.testing.assert_allclose(got[1].sum(-1).numpy(), 1.0, atol=1e-6)


def test_mixup_seeds_cover_both_branches():
    chosen = {bool(jax_mix_draws(jax.random.PRNGKey(s)).use_cutmix) for s in range(6)}
    assert chosen == {True, False}


def test_cutmix_lambda_is_the_clipped_box_area():
    """A box centred in a corner is clipped: the effective lambda is one
    minus the clipped area fraction, and the targets follow it."""
    x = torch.zeros((2, 10, 10, 1))
    x[1] = 1.0
    draws = MixDraws(torch.tensor(True), torch.tensor(0.64), torch.tensor(0.0),
                     torch.tensor(0.0))
    out, targets = mixup_cutmix(x, torch.tensor([0, 1]), draws, num_classes=2)
    # side 0.6 * 10 = 6 centred on (0, 0): the clipped box is 3 x 3
    assert out[0].sum().item() == 9.0
    np.testing.assert_allclose(targets[0].numpy(), [0.91, 0.09], atol=1e-6)
