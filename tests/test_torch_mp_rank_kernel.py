"""The MP-rank kernel's wrapper (`spectral/mp_rank_kernel.py`) and its gate
(`spectral/ops.py:use_mp_kernel`), on the CPU: the kernel itself runs only
on the card (chip_smoke.py phase 5f holds it against the plain version and
the float64 oracle there), so these hold the routes by n, the cluster
sizes against the library's shared-memory layout, the plain route bit for
bit, and the launch's arguments against a recording stand-in library."""

import ctypes
import re

import numpy as np
import pytest
import torch

from basd_tpu_torch import kernels
from basd_tpu_torch.spectral import mp_rank_kernel as mk
from basd_tpu_torch.spectral import ops as tops
from basd_tpu_torch.spectral import tridiag
from basd_tpu_torch.spectral.tridiag import mp_rank_sturm

torch.set_num_threads(1)

SOURCE = (kernels.CSRC / "mp_rank.cu").read_text()


def _designed_grams(rng, b: int, n: int, m: int) -> tuple[torch.Tensor, list[int]]:
    """fp32 Grams m V diag(lam) V^T whose covariance has a planted number
    of eigenvalues 3 to 30 times the MP edge factor, the rest uniform
    within min(0.4, (edge - 1) / 2) of 1, so the median lies near 1 and the
    bulk below the threshold: the MP rank is the planted one, far from any
    eigenvalue."""
    edge = (1.0 + (n / m) ** 0.5) ** 2
    half = min(0.4, (edge - 1.0) / 2)
    grams, ranks = [], []
    for _ in range(b):
        r = int(rng.integers(1, n // 4))
        lam = np.concatenate([edge * rng.uniform(3.0, 30.0, r),
                              rng.uniform(1.0 - half, 1.0 + half, n - r)])
        v = np.linalg.qr(rng.standard_normal((n, n)))[0]
        grams.append((v * (m * lam)) @ v.T)
        ranks.append(r)
    return torch.from_numpy(np.stack(grams).astype(np.float32)), ranks


@pytest.mark.parametrize("n, route", [
    (4, "eigvalsh"), (7, "eigvalsh"), (8, "kernel"), (192, "kernel"), (384, "kernel"),
    (512, "kernel"), (mk.MAX_N, "kernel"), (mk.MAX_N + 1, "plain"), (768, "plain"),
])
def test_gate_routes_by_n(n, route, monkeypatch):
    """n = 192 and 384 (the cells' D_s) and every n from 8 to MAX_N go to
    the wrapper; above, `mp_rank_sturm`; below 8, `eigvalsh`."""
    calls = []
    monkeypatch.setattr(tops, "kernel_mp_rank_gram",
                        lambda g, m: calls.append("kernel") or torch.zeros(g.shape[:-2]))
    monkeypatch.setattr(tops, "mp_rank_sturm",
                        lambda c, m: calls.append("plain") or torch.zeros(c.shape[:-2]))
    eigvalsh = torch.linalg.eigvalsh
    monkeypatch.setattr(torch.linalg, "eigvalsh",
                        lambda c: calls.append("eigvalsh") or eigvalsh(c))
    tops.marchenko_pastur_rank_gram(torch.eye(n)[None], 4 * n)
    assert calls == [route]
    assert tops.use_mp_kernel(n) == (route == "kernel")
    assert mk.MAX_N >= 512


@pytest.mark.parametrize("n, want", [(8, 1), (192, 1), (238, 1), (239, 2), (384, 4),
                                     (512, 8), (mk.MAX_N, 8)])
def test_cluster_size_fits_its_shared_memory(n, want):
    """The least power of two whose slice of rows fits one CTA's shared
    memory: one CTA at Table-3's n = 192, four at Table-1's 384."""
    c = mk.cluster_size(n)
    assert c == want
    assert mk.smem_bytes(n, c) <= mk.SMEM_LIMIT
    assert all(mk.smem_bytes(n, s) > mk.SMEM_LIMIT for s in (1, 2, 4, 8) if s < c)
    assert mk.cluster_size(mk.MAX_N + 1) is None


def test_layout_constants_match_the_source():
    """The wrapper's copy of the library's shared-memory layout and limits."""
    def const(name):
        return int(re.search(rf"constexpr \w+ {name} = (\d+);", SOURCE).group(1))

    assert const("kSmemLimit") == mk.SMEM_LIMIT
    assert const("kScratch") == mk.SCRATCH_FLOATS
    assert re.findall(r"case (\d+): return launch<\1>", SOURCE) == list(map(str, mk.CLUSTERS))
    assert const("kMinN") == mk.MIN_N
    assert "return rows * n + 5 * (size_t)n + kScratch;" in SOURCE
    assert const("kShifts") == 128 and const("kRounds") == tridiag.BRACKET_ROUNDS


@pytest.mark.parametrize("b, n, m", [(3, 192, 640), (2, 384, 65792), (4, 8, 32), (3, 33, 100)])
def test_cpu_wrapper_is_mp_rank_sturm_bit_for_bit(b, n, m):
    """A CPU tensor through the wrapper, and through the selector's
    `marchenko_pastur_rank_gram`, gives `mp_rank_sturm`'s ranks on the
    symmetrised covariance, at the cells' n and sample counts; on the
    designed spectra those are the planted ranks. Nothing is launched."""
    gram, planted = _designed_grams(np.random.default_rng(n), b, n, m)
    before = dict(kernels.LAUNCHES)
    got = mk.kernel_mp_rank_gram(gram, m)
    cov = gram / m
    want = mp_rank_sturm((cov + cov.transpose(-1, -2)) * 0.5, m)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(tops.marchenko_pastur_rank_gram(gram, m), want)
    assert want.tolist() == planted
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("mean_scale", [3.0, 30.0])
def test_plain_rank_equals_the_oracle_far_below_the_top(mean_scale):
    """Uncentered Grams of features that share a strong mean put the top
    eigenvalue 1e4 (mean_scale 3) to 1e6 (30) times the median, as the
    Table-1 teacher's do. The bracket's BRACKET_ROUNDS rounds find the
    median to its fp32 spacing there, so the ranks equal the float64
    oracle's on every matrix, none of which has an eigenvalue within 1e-4
    of the edge; 3 rounds, the JAX package's, miss at 1e6."""
    n, m, b = 128, 4096, 8
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, m, n)) * np.exp(-np.linspace(0.0, 3.0, n))
    x = x * rng.uniform(0.5, 2.0, (b, 1, n)) + mean_scale * rng.standard_normal((b, 1, n))
    cov = torch.from_numpy(np.einsum("bmi,bmj->bij", x, x).astype(np.float32)) / m
    cov = (cov + cov.transpose(-1, -2)) * 0.5
    w = np.linalg.eigvalsh(cov.double().numpy())
    top_over_median = w[:, -1] / np.median(w, axis=-1)
    assert top_over_median.min() > 1e3 * mean_scale ** 2 / 9
    lam = np.median(w, axis=-1) * (1.0 + (n / m) ** 0.5) ** 2
    assert np.abs(w / lam[:, None] - 1.0).min() > 1e-4
    oracle = (w > lam[:, None]).sum(-1)
    assert mp_rank_sturm(cov, m).tolist() == oracle.tolist()
    if mean_scale == 30.0:
        assert mp_rank_sturm(cov, m, rounds=3).tolist() != oracle.tolist()


def test_cpu_wrapper_keeps_leading_axes():
    gram, _ = _designed_grams(np.random.default_rng(0), 6, 24, 96)
    got = mk.kernel_mp_rank_gram(gram.reshape(2, 3, 24, 24), 96)
    assert got.shape == (2, 3)
    assert torch.equal(got.reshape(6), mk.kernel_mp_rank_gram(gram, 96))


class _RecordingLibrary:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if name != "basd_mp_rank":
            raise AttributeError(name)
        return lambda *args: self.calls.append(args) or 0


@pytest.mark.parametrize("n, cluster", [(192, 1), (384, 4), (239, 2), (512, 8)])
def test_raw_launch_passes_shapes_and_counts_one_launch(n, cluster, monkeypatch):
    """`mp_rank_raw_cuda` allocates (B,) int32 ranks, (B, n) diag and
    (B, n - 1) off^2, passes the cluster the wrapper picks, m and the fp32
    edge factor (1 + sqrt(n / m))^2, and counts one launch a call."""
    lib = _RecordingLibrary()
    monkeypatch.setattr(mk.kernels, "library", lambda name: lib)
    monkeypatch.setattr(mk, "_stream", lambda a: 7)
    monkeypatch.setitem(mk.kernels.LAUNCHES, "mp_rank", 0)
    gram = torch.zeros((3, n, n))
    ranks, diag, off2 = mk.mp_rank_raw_cuda(gram, 640)
    assert (ranks.shape, ranks.dtype) == ((3,), torch.int32)
    assert diag.shape == (3, n) and off2.shape == (3, n - 1)
    [args] = lib.calls
    assert args[:4] == (gram.data_ptr(), ranks.data_ptr(), diag.data_ptr(), off2.data_ptr())
    assert args[4:7] == (3, n, cluster)
    assert isinstance(args[7], ctypes.c_float) and args[7].value == 640.0
    edge = np.float32((1.0 + (n / 640) ** 0.5) ** 2)
    assert isinstance(args[8], ctypes.c_float) and np.float32(args[8].value) == edge
    assert args[9] == 7
    assert mk.kernels.LAUNCHES["mp_rank"] == 1


@pytest.mark.parametrize("shape, dtype, what", [
    ((2, 7, 7), torch.float32, "8 <= n"),
    ((2, mk.MAX_N + 1, mk.MAX_N + 1), torch.float32, "8 <= n"),
    ((2, 16, 24), torch.float32, "square"), ((2, 16, 16), torch.float64, "fp32"),
    ((16, 16), torch.float32, r"\(B, n, n\)"),
])
def test_raw_launch_refuses_what_the_kernel_does_not_take(shape, dtype, what, monkeypatch):
    monkeypatch.setattr(mk.kernels, "library", lambda name: pytest.fail("launched"))
    with pytest.raises(ValueError, match=what):
        mk.mp_rank_raw_cuda(torch.zeros(shape, dtype=dtype), 64)
    with pytest.raises(ValueError, match="contiguous"):
        mk.mp_rank_raw_cuda(torch.zeros((2, 16, 16)).transpose(1, 2), 64)
