"""The port's samplers: the distributions of the augmentation draws that the
train step takes from its `torch.Generator`. Each test draws from a fixed
seed on the CPU, so its result is deterministic; the statistical tests
reject at p < 1e-3."""

import math

import numpy as np
import pytest
import torch
from scipy import stats

from basd_tpu_torch.ops import augment as taug
from basd_tpu_torch.ops.mixup import sample_mixup
from basd_tpu_torch.training.train_step import sample_step_draws

torch.set_num_threads(1)

N = 14_000
P_MIN = 1e-3


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_op_is_uniform_over_14():
    op = taug.sample_trivial_augment(_gen(0), N).op
    assert op.dtype == torch.int64
    counts = np.bincount(op.numpy(), minlength=14)
    assert len(counts) == 14 and counts.min() > 0
    assert stats.chisquare(counts).pvalue > P_MIN


def test_magnitude_is_uniform_over_31_bins():
    mag = taug.sample_trivial_augment(_gen(1), N).mag.numpy()
    bins = np.rint(mag * 30).astype(int)
    np.testing.assert_array_equal(mag, (bins / np.float32(30.0)).astype(np.float32))
    counts = np.bincount(bins, minlength=31)
    assert len(counts) == 31 and counts.min() > 0
    assert stats.chisquare(counts).pvalue > P_MIN


def test_sign_and_flip_are_fair_coins():
    sign = taug.sample_trivial_augment(_gen(2), N).sign.numpy()
    assert set(np.unique(sign)) == {-1.0, 1.0}
    assert stats.binomtest(int((sign > 0).sum()), N).pvalue > P_MIN
    flip = taug.sample_flip(_gen(3), N)
    assert flip.dtype == torch.bool
    assert stats.binomtest(int(flip.sum()), N).pvalue > P_MIN


def test_crop_draws_cover_their_ranges_uniformly():
    d = taug.sample_crop(_gen(4), N // 10)
    lo, hi = math.log(3 / 4), math.log(4 / 3)
    for x, a, b in [(d.area_frac, 0.08, 1.0), (d.log_ratio, lo, hi),
                    (d.u_i, 0.0, 1.0), (d.u_j, 0.0, 1.0)]:
        x = x.numpy().ravel()
        assert x.shape == (N,) and a <= x.min() and x.max() < b
        assert stats.kstest(x, "uniform", args=(a, b - a)).pvalue > P_MIN


def test_crop_takes_the_first_attempt_that_fits():
    """Each sampled crop's size is its first attempt whose crop fits in the
    image, or the full image (the largest in-ratio crop of a square) when
    none fits."""
    b, raw, out = 400, 40, 8
    d = taug.sample_crop(_gen(5), b)
    target = raw * raw * d.area_frac
    aspect = d.log_ratio.exp()
    cw, ch = (target * aspect).sqrt(), (target / aspect).sqrt()
    fits = ((cw <= raw) & (ch <= raw)).numpy()
    first = fits.argmax(1)
    assert (first > 0).any()  # some samples skip an attempt that does not fit
    # one image per sample whose pixel values are their column index: the
    # crop's column span shows its width
    cols = torch.arange(raw, dtype=torch.float32)
    images = cols[None, None, :, None].expand(b, raw, raw, 1).contiguous()
    crop = taug.random_resized_crop(images, d, out)
    width = (crop[:, 0, -1, 0] - crop[:, 0, 0, 0]) * out / (out - 1)
    want = np.where(fits.any(1), cw.numpy()[np.arange(b), first], raw)
    np.testing.assert_allclose(width.numpy(), want, rtol=1e-4, atol=1e-3)


def test_mix_draws():
    """cutmix with p = 0.5, lam ~ Beta(1, 1) (Kolmogorov-Smirnov), the box
    centres uniform."""
    g = _gen(6)
    draws = [sample_mixup(g) for _ in range(2000)]
    cut, lam, by, bx = (np.array([float(d[i]) for d in draws]) for i in range(4))
    assert stats.binomtest(int(cut.sum()), len(cut)).pvalue > P_MIN
    for x in (lam, by, bx):
        assert stats.kstest(x, "uniform").pvalue > P_MIN
    assert stats.kstest(lam, stats.beta(1, 1).cdf).pvalue > P_MIN


@pytest.mark.parametrize("alpha", [0.4, 2.0])
def test_mix_lambda_beta_from_gammas(alpha):
    g = _gen(7)
    lam = np.array([float(sample_mixup(g, alpha).lam) for _ in range(2000)])
    assert stats.kstest(lam, stats.beta(alpha, alpha).cdf).pvalue > P_MIN


def _leaves(draws):
    if isinstance(draws, torch.Tensor):
        return [draws]
    return [x for part in draws for x in _leaves(part)]


def test_step_draws_shapes_and_reproducibility():
    a, b = (_leaves(sample_step_draws(_gen(8), 5)) for _ in range(2))
    assert len(a) == 4 + 1 + 3 + 4  # crop, flip, augment, mix
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    a = sample_step_draws(_gen(8), 5)
    assert a.view.crop.area_frac.shape == (5, 10)
    assert a.view.flip.shape == a.view.augment.op.shape == (5,)
    assert a.mix.lam.shape == ()
