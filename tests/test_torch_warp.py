"""Kernel K4's plain version (`basd_tpu_torch.ops.warp_kernel`) against the
JAX package's warp: its Pallas kernel in interpret mode and its XLA tap
sweep (`augment._geometric_warp`), fp32 on the CPU, inputs from numpy
seeds. The CUDA kernel is held against this plain version on the card by
chip_smoke.py; here its wrapper's launches run against a recording
stand-in library."""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from basd_tpu.ops import augment as jaug
from basd_tpu.ops import warp_kernel as jwarp
from basd_tpu_torch.ops import augment as taug
from basd_tpu_torch.ops import warp_kernel as twarp

torch.set_num_threads(1)


def _images(b, n, seed):
    return np.random.default_rng(seed).random((b, n, n, 3)).astype(np.float32)


def _params(b, seed=7):
    """tests/test_ops.py's parameter set (every geometric op, at extremes,
    fractional translation, an exact quarter turn), plus +-135 degrees."""
    z = lambda: np.zeros(b, np.float32)
    angle, shx, shy, tx, ty = z(), z(), z(), z(), z()
    angle[1] = np.deg2rad(30)
    angle[2] = np.deg2rad(-135)
    angle[3] = np.pi / 2
    shx[4] = 0.99
    shy[5] = -0.8
    tx[6] = 3.7
    ty[7] = -12.0
    if b > 8:
        angle[8] = np.deg2rad(135)
        angle[9] = np.deg2rad(-45)
        tx[10], shx[11] = -32.0, -0.99
    flip = np.random.default_rng(seed).random(b) < 0.5
    return angle, shx, shy, tx, ty, flip


def _port(x, angle, shx, shy, tx, ty, flip=None):
    t = torch.from_numpy
    return twarp.fused_geometric_warp(
        t(x), t(angle), t(shx), t(shy), t(tx), t(ty),
        None if flip is None else t(flip)).numpy()


def _jax_xla(x, angle, shx, shy, tx, ty, flip):
    """The JAX package's XLA warp after an explicit hflip."""
    xf = np.where(flip[:, None, None, None], x[:, :, ::-1, :], x)
    a = jnp.asarray
    return np.asarray(jax.jit(jaug._geometric_warp)(
        a(xf), a(angle), a(shx), a(shy), a(tx), a(ty)))


def test_matches_the_interpret_mode_pallas_kernel():
    """B=8, n=32, the JAX tests' parameter set with +-135 degrees swapped
    in for two rows: atol 1e-5, the JAX package's fused-vs-XLA tolerance."""
    b, n = 8, 32
    x = _images(b, n, 11)
    angle, shx, shy, tx, ty, flip = _params(b)
    angle[0], angle[5], shy[5] = np.deg2rad(135), np.deg2rad(-135), 0.0
    a = jnp.asarray
    want = np.asarray(jax.jit(lambda x: jwarp.fused_geometric_warp(
        x, a(angle), a(shx), a(shy), a(tx), a(ty), a(flip), interpret=True))(a(x)))
    got = _port(x, angle, shx, shy, tx, ty, flip)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("n", [32, 33, 96])
def test_matches_the_xla_warp_after_flip(n):
    """Against `augment._geometric_warp` after hflip: atol 1e-6. n = 33 is
    odd (a half-integer centre); n = 96 takes the two-level shift (pass
    bounds above 40)."""
    b = 12
    x = _images(b, n, n)
    params = _params(b)
    np.testing.assert_allclose(_port(x, *params), _jax_xla(x, *params), atol=1e-6)
    assert max(twarp.pass_bounds(96)) > 40 >= max(twarp.pass_bounds(33))


def test_identity_parameters_are_bit_identical():
    x = _images(3, 24, 3)
    z = np.zeros(3, np.float32)
    np.testing.assert_array_equal(_port(x, z, z, z, z, z), x)
    np.testing.assert_array_equal(_port(x, z, z, z, z, z, np.zeros(3, bool)), x)


@pytest.mark.parametrize("flip", [False, True])
def test_exact_quarter_turns_are_permutations(flip):
    """k * 90 degrees, with and without the hflip, bit for bit against
    numpy: k = 1 is flip(swapaxes(x, 1, 2), axis=1), as `_quarter_turn`."""
    x = _images(5, 16, 5)
    angle = np.float32([0, np.pi / 2, np.pi, -np.pi / 2, 2 * np.pi])
    z = np.zeros(5, np.float32)
    fl = np.full(5, flip)
    got = _port(x, angle, z, z, z, z, fl)
    xf = x[:, :, ::-1] if flip else x
    for i, k in enumerate([0, 1, 2, 3, 0]):
        np.testing.assert_array_equal(got[i], np.rot90(xf[i], k, axes=(0, 1)))


def test_quarter_selection_matches_jax():
    """k and the residual of the packed rows equal the JAX package's at
    +-135 and +-45 degrees (the 1.5 and 0.5 ties of angle / (pi/2)), exact
    quarter turns and TrivialAugment's own rotate angles, computed in
    fp32 with the JAX op order."""
    mags = np.arange(31, dtype=np.float32) / np.float32(30.0)
    sm = np.concatenate([mags, -mags])
    angle = np.concatenate([
        (sm * np.float32(135.0)) * np.float32(math.pi / 180.0),
        np.float32([np.pi / 2, np.pi, -np.pi / 2, -np.pi]),
        np.deg2rad(np.float32([135, -135, 45, -45])).astype(np.float32),
    ]).astype(np.float32)
    ja = jnp.asarray(angle)
    quarter = jnp.round(ja / (jnp.pi / 2.0))
    want_k = np.asarray(jnp.mod(quarter.astype(jnp.int32), 4))
    want_res = np.asarray(ja - quarter * (jnp.pi / 2.0))
    z = torch.zeros(len(angle))
    rows = twarp.warp_params(torch.from_numpy(angle), z, z, z, z)
    np.testing.assert_array_equal(rows[:, 5].numpy(), want_k.astype(np.float32))
    # paeth and sin(residual) from the two libraries' tan and sin: 1e-7
    # (the other quarter-turn would move them by ~0.4)
    res = jnp.asarray(want_res)
    np.testing.assert_allclose(rows[:, 2].numpy(), np.asarray(-jnp.tan(res / 2.0)),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(rows[:, 1].numpy(), np.asarray(jnp.sin(res)),
                               rtol=0, atol=1e-7)
    # the +-135 degree rows of TrivialAugment (mag 30/30) sit on the tie
    assert np.float32(angle[30] / np.float32(np.pi / 2)) == np.float32(1.5)
    assert rows[30, 5].item() == 2.0 and rows[61, 5].item() == 2.0


def _trivialaugment_angles():
    """TrivialAugment's 62 rotate angles, +-m * 135 / 30 degrees, in fp32
    with the JAX package's op order."""
    mags = np.arange(31, dtype=np.float32) / np.float32(30.0)
    sm = np.concatenate([mags, -mags])
    return ((sm * np.float32(135.0)) * np.float32(math.pi / 180.0)).astype(np.float32)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


@pytest.mark.parametrize("angles", ["trivialaugment", "seeded"])
def test_rotation_terms_are_rounded_once_from_float64(angles):
    """Columns 0-2 (paeth + shear_x, sin(residual) + shear_y, paeth) are
    tan and sin of the fp32 residual in float64, rounded once: bit for bit
    numpy's float64-then-fp32, so they do not depend on the host's libm.
    Against the JAX package's fp32 `-jnp.tan(residual / 2)` and
    `jnp.sin(residual)` they are within 1 ulp everywhere; on
    TrivialAugment's angles tan is equal at all 62, sin at all but +-63 and
    +-81 degrees, where XLA's fp32 sin is not correctly rounded."""
    if angles == "trivialaugment":
        angle = _trivialaugment_angles()
    else:
        angle = np.random.default_rng(0).uniform(-math.pi, math.pi, 4000).astype(np.float32)
    ja = jnp.asarray(angle)
    quarter = jnp.round(ja / (jnp.pi / 2.0))
    residual = ja - quarter * (jnp.pi / 2.0)
    jtan = np.asarray(-jnp.tan(residual / 2.0))
    jsin = np.asarray(jnp.sin(residual))
    res = np.asarray(residual)
    z = torch.zeros(len(angle))
    rows = twarp.warp_params(torch.from_numpy(angle), z, z, z, z).numpy()
    want_tan = (-np.tan((res / np.float32(2.0)).astype(np.float64))).astype(np.float32)
    want_sin = np.sin(res.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(rows[:, 2], want_tan)
    np.testing.assert_array_equal(rows[:, 0], want_tan)
    np.testing.assert_array_equal(rows[:, 1], want_sin)
    assert _ulps(rows[:, 2], jtan).max() <= 1 and _ulps(rows[:, 1], jsin).max() <= 1
    if angles == "trivialaugment":
        np.testing.assert_array_equal(rows[:, 2], jtan)
        off = np.round(np.rad2deg(angle[_ulps(rows[:, 1], jsin) > 0]), 3)
        assert sorted(off) == [-81.0, -63.0, 63.0, 81.0]


def test_host_libm_does_not_enter_the_params(monkeypatch):
    """fp32 `torch.tan` and `torch.sin` made one ulp off (as another host's
    libm may round) leave the params unchanged: only float64 tan and sin
    reach them. The same stand-ins do move a direct fp32 call."""
    angle = torch.from_numpy(_trivialaugment_angles())
    z = torch.zeros(len(angle))
    want = twarp.warp_params(angle, z + 0.1, z - 0.2, z, z)
    for name in ("tan", "sin"):
        real = getattr(torch, name)

        def off_by_one(x, real=real):
            y = real(x)
            return y if x.dtype == torch.float64 else torch.nextafter(
                y, torch.full_like(y, math.inf))

        monkeypatch.setattr(torch, name, off_by_one)
        assert not torch.equal(off_by_one(angle), real(angle))
    got = twarp.warp_params(angle, z + 0.1, z - 0.2, z, z)
    assert torch.equal(got, want)


def test_host_libm_does_not_enter_the_affine_maps_or_the_crop(monkeypatch):
    """The augment path's other transcendentals, the non-square branch's
    cos and sin (`_inverse_affine`) and the crop's aspect ratio exp
    (`random_resized_crop`), are rounded once from float64 too: fp32 stand-ins
    one ulp off change neither."""
    angle = torch.from_numpy(_trivialaugment_angles())
    z = torch.zeros(len(angle))
    crop = taug.CropDraws(*(torch.from_numpy(np.random.default_rng(s).random(
        (8, 10)).astype(np.float32)) for s in range(4)))
    crop = crop._replace(log_ratio=(crop.log_ratio - 0.5) * 0.6)
    images = torch.from_numpy(_images(8, 40, 1))
    want = (taug._inverse_affine(angle, z + 0.1, z, z + 2.0, z),
            taug.random_resized_crop(images, crop, 32))
    for name in ("cos", "sin", "exp"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda x, real=real: real(x) if x.dtype ==
                            torch.float64 else torch.nextafter(real(x), torch.full_like(x, 9.0)))
    got = (taug._inverse_affine(angle, z + 0.1, z, z + 2.0, z),
           taug.random_resized_crop(images, crop, 32))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_pass_bounds_and_levels_match_jax():
    for n in (16, 32, 33, 96, 224):
        assert twarp.pass_bounds(n) == jwarp.pass_bounds(n)
        for bnd in twarp.pass_bounds(n):
            assert twarp._levels(bnd) == jwarp._levels(bnd)


class _RecordingLibrary:
    """Stands in for the warp kernel library: records each entry point
    called and its arguments, and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("basd_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("n", range(1, twarp.MAX_N + 1))
def test_raw_launch_takes_the_route_of_warp_route(n, c, monkeypatch):
    """`_warp_cuda` launches the entry point of the route that `warp_route`
    names, and only that, with (batch, n, C); one launch counted. C = 3
    takes one CTA per sample to n = 139 and a cluster of three CTAs above;
    C = 1 always fits one CTA."""
    lib = _RecordingLibrary()
    monkeypatch.setattr(twarp.kernels, "library", lambda name: lib)
    monkeypatch.setattr(twarp, "_stream", lambda x: 0)
    monkeypatch.setitem(twarp.kernels.LAUNCHES, "warp", 0)
    twarp._warp_cuda(torch.zeros((2, n, n, c)), torch.zeros((2, 8)))
    [(entry, args)] = lib.calls
    route = twarp.warp_route(n, c)
    assert entry == f"basd_warp_{route}"
    assert args[3:6] == (2, n, c)
    assert route == ("cta" if c == 1 or n <= 139 else "cluster")
    assert twarp.kernels.LAUNCHES["warp"] == 1


def test_raw_launch_passes_pointers_sizes_and_stream(monkeypatch):
    """K4 at (2, 16, 16, 3): the images', output's and params' pointers,
    (batch, n, C) and the current stream, on the route `warp_route` names;
    one launch counted."""
    images = torch.from_numpy(_images(2, 16, seed=3))
    params = twarp.warp_params(*(torch.from_numpy(x[:2].copy()) for x in _params(8)[:5]))
    lib = _RecordingLibrary()
    monkeypatch.setattr(twarp.kernels, "library", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=7))
    monkeypatch.setitem(twarp.kernels.LAUNCHES, "warp", 0)
    out = twarp._warp_cuda(images, params)
    assert twarp.warp_route(16, 3) == "cta"
    assert out.shape == images.shape and out.dtype == torch.float32
    assert lib.calls == [("basd_warp_cta", (images.data_ptr(), out.data_ptr(),
                                            params.data_ptr(), 2, 16, 3, 7))]
    assert twarp.kernels.LAUNCHES["warp"] == 1


def test_warp_routes_by_shape():
    """A sample's C planes in one CTA while they fit 227 KB (row stride
    odd: n + 1 for even n, n for odd n), a cluster of C <= 8 CTAs above,
    one CTA per sample and channel beyond 8 channels; n > 240 refused."""
    assert [twarp.plane_ld(n) for n in (1, 32, 33, 224)] == [1, 33, 33, 225]
    assert twarp.warp_route(139, 3) == "cta" and twarp.warp_route(140, 3) == "cluster"
    assert twarp.warp_route(240, 1) == "cta" and twarp.warp_route(240, 2) == "cluster"
    assert twarp.warp_route(240, 8) == "cluster" and twarp.warp_route(240, 9) == "plane"
    assert twarp.warp_route(32, 16) == "cta" and twarp.warp_route(96, 16) == "plane"
    with pytest.raises(ValueError, match="1 <= n <= 240"):
        twarp.warp_route(241, 3)
