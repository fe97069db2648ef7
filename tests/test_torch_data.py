"""The port's data layer (M7) against the JAX package's: dataset metadata,
synthetic splits byte for byte (in RAM and through the memory-mapped disk
cache), channel statistics (equal float64 values), streaming samples and
the epoch batch order; the native host library against its numpy plain
version; the device pipeline on the CPU. Nothing here reaches the network:
only the synthetic family and the builtin registry load data."""

from pathlib import Path

import numpy as np
import pytest
import torch

from basd_tpu.data import datasets as jdata
from basd_tpu.data import pipeline as jpipeline
from basd_tpu_torch.data import datasets as tdata
from basd_tpu_torch.data import native as tnative
from basd_tpu_torch.data import pipeline as tpipeline

torch.set_num_threads(1)

SYNTHETIC = [
    "synthetic/cifar10-like",
    "synthetic/cifar100-like-1024n",
    "synthetic/cifar10-like-32px-7c-300n",
]
BUILTIN = [
    "uoft-cs/cifar100", "uoft-cs/cifar10", "ILSVRC/imagenet-1k",
    "barkermrl/imagenet-a", "songweig/imagenet_sketch",
]


@pytest.fixture
def both_caches(tmp_path, monkeypatch):
    """Both packages' disk caches in a temporary directory, their split
    caches cleared before and after."""
    monkeypatch.setenv("BASD_DATA_CACHE", str(tmp_path))
    for mod in (jdata, tdata):
        mod.load_split_arrays.cache_clear()
    yield tmp_path
    for mod in (jdata, tdata):
        mod.load_split_arrays.cache_clear()


@pytest.mark.parametrize("name", SYNTHETIC + BUILTIN)
def test_dataset_info_equals_the_jax_packages(name):
    assert tdata.dataset_info(name) == jdata.dataset_info(name)


@pytest.mark.parametrize("name", [
    "uoft-cs/cifar100", "org/name", "./local/dir", "~/data/x", "a/b/c",
])
def test_hf_name_resolution_equals_the_jax_packages(name, tmp_path):
    def resolve(mod):
        try:
            return mod._hf_load_args(name)
        except RuntimeError as e:
            return str(e)

    assert resolve(tdata) == resolve(jdata)
    local = tmp_path / "imagefolder"
    local.mkdir()
    assert tdata._hf_load_args(str(local)) == jdata._hf_load_args(str(local))


@pytest.mark.parametrize("child,parent", [
    ("songweig/imagenet_sketch", "ILSVRC/imagenet-1k"),
    ("synthetic/cifar10-like", "synthetic/cifar10-like"),
    ("barkermrl/imagenet-a", "ILSVRC/imagenet-1k"),
    ("uoft-cs/cifar10", "uoft-cs/cifar100"),
])
def test_subset_indices_equal_the_jax_packages(child, parent):
    def subset(mod):
        try:
            return mod.get_subset_indices(child, parent)
        except RuntimeError as e:
            return f"raised: {e}"

    assert subset(tdata) == subset(jdata)


@pytest.mark.parametrize("name", SYNTHETIC)
@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_splits_are_byte_identical_in_ram(name, split, both_caches):
    ti, tl = tdata.load_split_arrays(name, split)
    ji, jl = jdata.load_split_arrays(name, split)
    assert not isinstance(ti, np.memmap)
    assert (ti.dtype, tl.dtype, ti.shape) == (ji.dtype, jl.dtype, ji.shape)
    assert ti.tobytes() == ji.tobytes() and tl.tobytes() == jl.tobytes()
    assert not list(both_caches.iterdir())  # small splits stay in RAM


@pytest.mark.parametrize("name", SYNTHETIC[:2])
def test_synthetic_splits_are_byte_identical_through_the_memmap_cache(
        name, both_caches, monkeypatch):
    for mod in (jdata, tdata):
        monkeypatch.setattr(mod, "_RAM_BYTES_LIMIT", 64 << 10)
    ti, tl = tdata.load_split_arrays(name, "train")
    ji, jl = jdata.load_split_arrays(name, "train")
    assert isinstance(ti, np.memmap) and not ti.flags.writeable
    assert ti.tobytes() == ji.tobytes() and tl.tobytes() == jl.tobytes()
    cached = sorted(p.name for p in (both_caches / name.replace("/", "__")).iterdir())
    assert cached == [f"train_{ti.shape[1]}px.images.npy", f"train_{ti.shape[1]}px.labels.npy"]
    # a second load maps the same file
    tdata.load_split_arrays.cache_clear()
    again, _ = tdata.load_split_arrays(name, "train")
    assert again.tobytes() == ti.tobytes()
    # batches of a read-only map are writable copies, and go to a tensor
    rng = np.random.default_rng(0)
    imgs, labs = next(tpipeline.epoch_batches(ti, tl, 8, rng))
    assert imgs.flags.writeable and not np.shares_memory(imgs, ti)
    (t,) = tpipeline.to_device((ti[:4],), "cpu")
    assert torch.equal(t, torch.from_numpy(np.array(ti[:4])))


def test_cache_goes_to_the_ports_own_directory(monkeypatch):
    monkeypatch.delenv("BASD_DATA_CACHE", raising=False)
    root = Path(tdata.__file__).resolve().parents[2]
    assert tdata._cache_dir() == root / ".cache" / "basd_tpu_torch"


@pytest.mark.parametrize("name", SYNTHETIC)
def test_channel_stats_equal_the_jax_packages(name):
    assert tdata.get_channel_stats(name) == jdata.get_channel_stats(name)


def test_streamed_samples_equal_the_jax_packages():
    t = list(tdata.iter_split_samples("synthetic/cifar10-like", "test", limit=40))
    j = list(jdata.iter_split_samples("synthetic/cifar10-like", "test", limit=40))
    assert len(t) == len(j) == 40
    for (ti, tl), (ji, jl) in zip(t, j):
        assert ti.tobytes() == ji.tobytes() and tl == jl


@pytest.mark.parametrize("seed,n,batch,drop_last", [
    (42 * 100_003, 512, 16, True), (7, 100, 16, False), (0, 33, 8, True),
])
def test_epoch_batches_give_the_jax_packages_order(seed, n, batch, drop_last):
    images = np.arange(n, dtype=np.uint8)[:, None, None, None] * np.ones((1, 2, 2, 3), np.uint8)
    labels = np.arange(n, dtype=np.int32)
    got = list(tpipeline.epoch_batches(images, labels, batch,
                                       np.random.default_rng(seed), drop_last=drop_last))
    want = list(jpipeline.epoch_batches(images, labels, batch,
                                        np.random.default_rng(seed), drop_last=drop_last))
    assert len(got) == len(want)
    for (gi, gl), (wi, wl) in zip(got, want):
        assert np.array_equal(gl, wl) and np.array_equal(gi, wi)


def test_prefetch_to_device_keeps_order_and_types():
    images = np.arange(6 * 4 * 4 * 3, dtype=np.uint8).reshape(6, 4, 4, 3)
    labels = np.arange(6, dtype=np.int32)
    batches = [(images[i : i + 2], labels[i : i + 2]) for i in range(0, 6, 2)]
    out = list(tpipeline.prefetch_to_device(iter(batches), device="cpu", size=2))
    assert len(out) == 3
    for (ti, tl), (ni, nl) in zip(out, batches):
        assert ti.dtype == torch.uint8 and tl.dtype == torch.int64
        assert np.array_equal(ti.numpy(), ni) and np.array_equal(tl.numpy(), nl)


# ---- the native host library against its numpy plain version ----


def test_native_library_builds_into_the_ports_build_directory():
    tnative.library()
    path = tnative._lib_path()
    assert path.exists() and path.parent == Path(tnative.__file__).resolve().parents[1] / "_build"


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "basd_host.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_SOURCE", bad)
    monkeypatch.setattr(tnative, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        tnative.resize_batch_u8(np.zeros((1, 4, 4, 3), np.uint8), 2, 2)


@pytest.mark.parametrize("shape,out", [
    ((3, 24, 20, 3), (16, 16)), ((2, 7, 9, 3), (13, 5)), ((1, 4, 4, 1), (12, 12)),
])
def test_native_resize_matches_the_plain_version(shape, out):
    """Within one level: the library interpolates as a + f (b - a), the
    numpy version as (1 - f) a + f b (the JAX package's native test holds
    its library to its float reference with the same tolerance)."""
    rng = np.random.default_rng(0)
    imgs = (rng.random(shape) * 255).astype(np.uint8)
    got = tnative.resize_batch_u8(imgs, *out)
    want = tnative.resize_batch_u8_plain(imgs, *out)
    assert got.shape == want.shape == (shape[0], *out, shape[3])
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_native_resize_identity_and_constant():
    imgs = np.arange(2 * 8 * 8 * 3, dtype=np.uint8).reshape(2, 8, 8, 3)
    assert tnative.resize_batch_u8(imgs, 8, 8) is imgs
    flat = np.full((1, 4, 4, 3), 77, np.uint8)
    assert (tnative.resize_batch_u8(flat, 12, 12) == 77).all()


def test_native_welford_matches_the_plain_version_and_direct_stats():
    rng = np.random.default_rng(2)
    imgs = (rng.random((20, 10, 10, 3)) * 255).astype(np.uint8)
    native = tnative.WelfordStats(3)
    mean, m2, count = np.zeros(3), np.zeros(3), np.zeros(1, np.int64)
    for img in imgs:
        native.update(img)
        tnative.welford_update_plain(mean, m2, count, img.reshape(-1, 3))
    np.testing.assert_allclose(native.mean, mean, atol=1e-12)
    np.testing.assert_allclose(native.m2, m2, atol=1e-9)
    assert native.count[0] == count[0] == 2000
    flat = imgs.reshape(-1, 3).astype(np.float64) / 255.0
    got_mean, got_std = native.result()
    np.testing.assert_allclose(got_mean, flat.mean(0), atol=1e-9)
    np.testing.assert_allclose(got_std, flat.std(0), atol=1e-9)


def test_welford_refuses_more_channels_than_the_library_holds():
    with pytest.raises(ValueError, match="1..8"):
        tnative.WelfordStats(9)
